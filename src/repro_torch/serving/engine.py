"""Batched serving engine over the banked paged-KV pool (port of
``repro.serving.engine``).

In the default ``kv_mode="paged"`` the prefill K/V is ingested into
per-layer bank-major page pools (one ``banked_scatter_pair`` call per
layer for its K and V pools) and every decode step moves all KV traffic
through the CUDA kernels on those pools, one launch per layer for K and V:

  * read: each step gathers every sequence's page list from the K and V
    pools (``banked_gather_pair``, the paged-attention read);
  * write: the new token's K/V goes into the gathered view and each
    sequence's current page is written back (``banked_scatter_pair``, a
    read-modify-write append, in place).

Every decode step also records its exact ``AddressTrace`` (``step_trace``
/ ``serving_trace``), so ``cost_many`` prices the serving traffic on the
paper's memories.  ``kv_mode="dense"`` keeps the seq-contiguous reference
cache the paged path is held against.  An SSM layer (falcon-mamba,
jamba's Mamba layers) has no pages: its recurrent state rides beside the
pools, one {"h", "conv"} a layer, and a model with no attention layer
serves with no pool and an empty KV trace.

``run_scheduler`` is the continuous-batching half: a
``scheduler.Scheduler`` admits, decodes and retires requests lane by lane,
and each tick's lane-ragged decode step runs through the same paired row
kernels, with per-lane positions (``_paged_attention_decode_ragged``).
Under a ``runtime.FaultPlan`` a bank loss moves the dead bank's live pages
through the paired row kernels, a corrupted page is rebuilt by a
re-prefill and a replay of its request's decode steps, and a transient
decode fault is retried.  A preemption (a ``preempt`` event or a tripped
``runtime.PreemptionGuard``) checkpoints the pools and the scheduler's
state through ``repro_torch.checkpoint``, and a second ``run_scheduler``
call resumes the day from it.

On a mesh (``ax`` from ``make_axes``; ``NO_AXES`` for one device) each
rank holds its shards of ``params``, placed by ``ax.resolve``, and is
handed the whole request batch.  The prefill runs as
``transformer.prefill`` runs on a mesh (``ax.for_batch``: this rank's
rows, its block of the cache), and so does ``kv_mode="dense"``'s decode,
its logits gathered over the batch axes before sampling, so every rank
draws the same tokens.  The page pools get no placement, as in the
reference: they stay whole on every rank, and the paged steps run on
``ax`` with an empty batch, the mesh splitting the weights only (each
block's gathered just before the block and dropped after it), every rank
running every lane through the row kernels on its own pools.  An
admission gathers its prefill K/V whole before lowering it to page rows:
the only KV bytes that cross ranks.  A preemption's checkpoint is written
by rank 0 and restored by every rank.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import arch as _arch
from repro_torch.launch.sharding import (NO_AXES, Axes, gather_shard,
                                         local_shard, own_block,
                                         shard_index)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.serving import kvcache as KV


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, new) generated ids
    prompt_len: int
    steps: int


@dataclass
class SchedulerRunResult:
    """One continuous-batching run: per-request generated ids (rid-keyed;
    a request's array has exactly ``max_new_tokens`` entries), the
    scheduler's run statistics (makespan, lane occupancy, bank-occupancy
    skew, fault counters) and the tick count.  A preempted run has
    ``preempted=True`` and ``checkpoint``, the path of the step directory
    it saved; resuming from it finishes the day."""
    outputs: dict[int, np.ndarray]
    stats: dict
    ticks: int
    preempted: bool = False
    checkpoint: str | None = None


class _RaggedStep(NamedTuple):
    """One ragged decode step's index and mask tensors on the device, the
    same for every layer: the lanes' page lists (``ids``, (B·P,)), each
    lane's current page (``cur``, (B,); idle lanes name the scratch page)
    and its slots in the gathered view (``line``, (B, page_len)), per-lane
    positions (``pos``), the slot each active lane writes (``hot``) and the
    slots it may attend to (``valid``, both (B, P·page_len))."""
    ids: torch.Tensor
    cur: torch.Tensor
    line: torch.Tensor
    pos: torch.Tensor
    hot: torch.Tensor
    valid: torch.Tensor


class ServeEngine:
    def __init__(self, cfg: ModelConfig, rc: RunConfig, params: dict,
                 ax: Axes, max_batch: int = 8, max_seq: int = 256,
                 mem_arch="16B", kv_mode: str = "paged", page_len: int = 8,
                 device="cuda"):
        self.cfg, self.rc, self.ax = cfg, rc, ax
        self.params = params
        #: the paged steps' context: ``ax`` with an empty batch (module
        #: docstring)
        self._lanes = ax if ax.mesh is None else dataclasses.replace(
            ax, batch=())
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
        self._sched_traces: list = []
        self._sched_meta: dict = {}
        #: final PageTableState of the last paged generate
        self.last_pages: KV.PageTableState | None = None
        #: the per-layer decode state of the last paged ``generate`` or
        #: ``run_scheduler`` (key ``b{j}s{sb}`` -> {"k", "v"} pools, whole
        #: on every rank of a mesh, or an SSM layer's {"h", "conv"}, on a
        #: mesh this rank's block over ``dinner``)
        self.last_pools: dict | None = None

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

    # -- a mesh --------------------------------------------------------------

    def _my_rows(self, x: torch.Tensor, ax: Axes) -> torch.Tensor:
        """This rank's rows of the whole batch ``x`` on ``ax``."""
        return x if ax.mesh is None else local_shard(x, (ax.batch,), ax.mesh)

    def _all_rows(self, x: torch.Tensor, ax: Axes) -> torch.Tensor:
        """The whole batch from every rank's rows ``x`` on ``ax``."""
        return x if ax.mesh is None else gather_shard(x, (ax.batch,),
                                                      ax.mesh)

    def _prefill_positions(self, j: int, plen: int) -> int:
        """The positions pattern block ``j``'s prefill cache keeps of a
        ``plen``-token prompt: the prompt, or its window."""
        w = T._block_window(self.cfg, j)
        return min(plen, w) if w else plen

    def _whole_prefill(self, cache: dict, plen: int, batch: int) -> dict:
        """The prefill cache of ``batch`` rows as the paged steps take it:
        on a mesh each K/V made whole (its rows and positions gathered,
        once per admission) and each SSM state moved to the placement
        ``ssm.py`` gives it on the paged steps' context (every row, its
        ``dinner`` still split); off a mesh ``cache`` itself."""
        ax = self.ax.for_batch(batch)
        if ax.mesh is None:
            return cache
        held = S._state_placement(self.cfg, ax, batch // ax.batch_size())
        lanes = S._state_placement(self.cfg, self._lanes, batch)
        out = {}
        for j, (kind, _) in enumerate(self.cfg.block_pattern()):
            bc = cache["blocks"][f"b{j}"]
            if kind == "attn":
                spec = (None, ax.batch,
                        L.seq_axes(ax, self._prefill_positions(j, plen)))
                out[f"b{j}"] = {name: gather_shard(t, spec, ax.mesh)
                                for name, t in bc.items()}
                continue
            out[f"b{j}"] = {name: own_block(gather_shard(
                t, (None, ax.batch) + held[name][1:], ax.mesh),
                (None,) + lanes[name], ax.mesh) for name, t in bc.items()}
        return {"blocks": out}

    def _decode_layers(self, params, tok, pools, pos, attn_fn):
        """The model's decode step over the per-layer decode state
        ``pools`` (updated in place) with the paged attention ``attn_fn``,
        on the paged steps' context: on a mesh each block's weights are
        gathered just before it.  Returns (logits, pools)."""
        cfg, rc, ax = self.cfg, self.rc, self._lanes
        top, block = T._weights(cfg, params, ax)
        embed = top("embed")
        x = T._token_rows({"embed": embed}, tok,
                          getattr(torch, rc.compute_dtype))
        if not cfg.tie_embeddings:
            embed = None
        for sb in range(cfg.n_superblocks):
            for j, (kind, is_moe) in enumerate(cfg.block_pattern()):
                key = f"b{j}s{sb}"
                x, pools[key] = T.apply_block_decode(
                    cfg, rc, block(j, sb), x, pools[key], pos, kind, is_moe,
                    j, attn_fn=attn_fn, ax=ax)
        x = L.rmsnorm(top("final_norm"), x, cfg.norm_eps)
        return T._unembed(cfg, T._head(cfg, top, embed), x), pools

    # -- paged decode path -------------------------------------------------

    def _paged_attention_decode(self, cfg, p, x, cache, pos, ax, *,
                                window: int = 0, pages=None, step_pos=0):
        """``L.attention_decode`` against the banked page pool: gather the
        sequences' pages, insert the new token, attend, write each current
        page back.  Same einsums, masks and dtypes as the dense path.
        ``step_pos`` is ``pos`` on the host (it picks the current page
        without a device sync).  ``ax`` is the paged steps' context: the
        mesh splits no lane and no pool, so every rank attends every lane
        with the block's whole weights."""
        kv = self.kv_cfg
        b = x.shape[0]
        plen = kv.page_len
        n_pt = pages.page_table.shape[1]
        s_all = n_pt * plen
        kvh, hd = cfg.n_kv_heads, cfg.hd
        q, k_new, v_new = L._qkv(cfg, p, x, pos[None])
        ids = pages.page_table.clamp(min=0).reshape(-1)
        ck, cv = KV.gather_pages_pair(kv, cache["k"], cache["v"], ids)
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
        kp, vp = KV.scatter_pages_pair(kv, cache["k"], cache["v"], cur,
                                       k_line, v_line)
        return out, {"k": kp, "v": vp}

    def _paged_step(self, params, tok, pools, pages, pos: int):
        """One full-model decode step at position ``pos`` over the
        per-layer decode state ``pools`` (key ``b{j}s{sb}``: an attention
        layer's K/V page pools, updated in place, or an SSM layer's
        {"h", "conv"}, replaced by the step's new state).  Returns (logits,
        pools, pages)."""
        need = (pages.seq_lens % self.kv_cfg.page_len) == 0
        pages, _ = KV.allocate_pages(self.kv_cfg, pages, need)
        attn_fn = functools.partial(self._paged_attention_decode, pages=pages,
                                    step_pos=pos)
        logits, pools = self._decode_layers(
            params, tok, pools, torch.tensor(pos, device=self.device),
            attn_fn)
        return logits, pools, pages._replace(seq_lens=pages.seq_lens + 1)

    def _ingest_prefill(self, cache, plen: int, batch: int):
        """Allocate every prompt page and scatter the prefill K/V into the
        per-layer pools (one banked_scatter_pair call per attention layer);
        after this no dense KV state survives.  An SSM layer's prefill
        state ({"h", "conv"}, one superblock's slice) is its entry as it
        is: it has no pages.  Returns (pools, pages): the per-layer decode
        state ``_paged_step`` carries, and the page table.  On a mesh
        ``cache`` is this rank's block, made whole first
        (``_whole_prefill``)."""
        kv = self.kv_cfg
        cache = self._whole_prefill(cache, plen, batch)
        n_pref = -(-plen // kv.page_len)
        pages = KV.fill_prompt_pages(kv, batch, self.max_seq, plen,
                                     self.device)
        ids = pages.page_table[:, :n_pref].clamp(min=0).reshape(-1)

        def rows_of(kc):
            # kc: (B, t, KV, HD) with t ≤ plen (a sliding-window prefill
            # keeps only the window; earlier slots stay zero and masked)
            t = kc.shape[1]
            buf = kc.new_zeros((batch, n_pref * kv.page_len) + kc.shape[2:])
            buf[:, plen - t:plen] = kc
            return buf.reshape(batch * n_pref, kv.row_width)

        pools = {}
        for j, (kind, _) in enumerate(self.cfg.block_pattern()):
            bc = cache["blocks"][f"b{j}"]
            for sb in range(self.cfg.n_superblocks):
                if kind != "attn":
                    pools[f"b{j}s{sb}"] = {name: leaf[sb]
                                           for name, leaf in bc.items()}
                    continue
                k_rows, v_rows = rows_of(bc["k"][sb]), rows_of(bc["v"][sb])
                k_pool, v_pool = KV.scatter_pages_pair(
                    kv, k_rows.new_zeros((kv.n_pages, kv.row_width)),
                    v_rows.new_zeros((kv.n_pages, kv.row_width)), ids,
                    k_rows, v_rows)
                pools[f"b{j}s{sb}"] = {"k": k_pool, "v": v_pool}
        return pools, pages

    # -- continuous-batching (lane-ragged) decode path -----------------------

    def _upload(self, *arrays) -> list:
        """Host integer / bool arrays as int64 tensors on the engine's
        device, in one copy: on the card from a pinned buffer, asynchronous
        (a copy from pageable memory would wait for the device to
        drain)."""
        flat = [np.asarray(a).reshape(-1) for a in arrays]
        sizes = [f.size for f in flat]
        pinned = self.device.type == "cuda"
        buf = torch.empty(sum(sizes), dtype=torch.int64, pin_memory=pinned)
        np.concatenate(flat, out=buf.numpy(), casting="unsafe")
        if pinned:
            buf = buf.to(self.device, non_blocking=True)
        return [t.reshape(np.shape(a)) for t, a in zip(buf.split(sizes),
                                                         arrays)]

    def _ragged_step(self, page_table, pos, active, scratch: int,
                     tok) -> tuple:
        """The device tensors of one ragged step from the scheduler's host
        snapshots: each lane's current page and page line are picked on the
        host (``min(pos // page_len, P - 1)``), so the step needs no device
        sync.  Returns (``_RaggedStep``, the (B, 1) token tensor)."""
        plen = self.kv_cfg.page_len
        pt = np.asarray(page_table, np.int64)
        pos = np.asarray(pos, np.int64)
        active = np.asarray(active, bool)
        b, n_pt = pt.shape
        pg = np.minimum(pos // plen, n_pt - 1)
        cur = np.where(active, np.maximum(pt[np.arange(b), pg], 0), scratch)
        line = (pg * plen)[:, None] + np.arange(plen)[None, :]
        ids, cur, line, pos_d, act, mapped, tok = self._upload(
            np.maximum(pt, 0), cur, line, pos, active, pt >= 0,
            np.asarray(tok, np.int64).reshape(b, 1))
        idx = torch.arange(n_pt * plen, device=self.device)
        act = act.bool()[:, None]
        hot = (idx[None, :] == pos_d[:, None]) & act
        valid = ((idx[None, :] <= pos_d[:, None]) & act
                 & torch.repeat_interleave(mapped.bool(), plen, dim=1))
        return _RaggedStep(ids.reshape(-1), cur, line, pos_d, hot,
                           valid), tok

    def _paged_attention_decode_ragged(self, cfg, p, x, cache, pos, ax, *,
                                       window: int = 0, step=None):
        """``_paged_attention_decode`` with per-lane positions: each lane
        attends up to its own position (``pos`` is (B,)) and writes back
        its own current page.  Lanes with no sequence to decode insert
        nothing and write to the reserved scratch page (the row kernels
        have no lane predication, so idle lanes need a sink; the trace
        predicates them off, see ``scheduler.scheduler_step_trace``).
        ``step`` holds the step's index and mask tensors; ``ax`` is the
        paged steps' context, as in ``_paged_attention_decode``."""
        kv = self.kv_cfg
        b = x.shape[0]
        s_all = step.hot.shape[1]
        kvh, hd = cfg.n_kv_heads, cfg.hd
        q, k_new, v_new = L._qkv(cfg, p, x, pos[:, None])
        ck, cv = KV.gather_pages_pair(kv, cache["k"], cache["v"], step.ids)
        ck = ck.reshape(b, s_all, kvh, hd)
        cv = cv.reshape(b, s_all, kvh, hd)
        hot = step.hot[:, :, None, None]
        ck = torch.where(hot, k_new.to(ck.dtype), ck)
        cv = torch.where(hot, v_new.to(cv.dtype), cv)
        valid = step.valid
        if window:
            idx = torch.arange(s_all, device=x.device)
            valid = valid & ((pos[:, None] - idx[None, :]) < window)
        s = torch.einsum("bqkgh,btkh->bkgqt", q,
                         ck.to(q.dtype)) / math.sqrt(hd)
        s = L.softcap(s, cfg.attn_softcap)
        s = torch.where(valid[:, None, None, None, :], s, L.NEG_INF)
        pr = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bkgqt,btkh->bqkgh", pr, cv.to(q.dtype))
        o = o.reshape(b, 1, cfg.n_heads, hd)
        out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
        # per-lane read-modify-write append of each lane's current page
        line = step.line[:, :, None, None]
        k_line = torch.take_along_dim(ck, line, dim=1).reshape(b, -1)
        v_line = torch.take_along_dim(cv, line, dim=1).reshape(b, -1)
        kp, vp = KV.scatter_pages_pair(kv, cache["k"], cache["v"], step.cur,
                                       k_line, v_line)
        return out, {"k": kp, "v": vp}

    def _scheduler_step(self, params, tok, pools, page_table, pos, active,
                        scratch: int):
        """One lane-ragged full-model decode step over the page pools
        (updated in place).  ``tok`` (B,) or (B, 1), ``page_table`` (B, P),
        ``pos`` (B,) and ``active`` (B,) are host arrays: the scheduler's
        snapshots, which own allocation (no in-step ``allocate_pages``).
        Returns (logits, pools)."""
        step, tok = self._ragged_step(page_table, pos, active, scratch, tok)
        attn_fn = functools.partial(self._paged_attention_decode_ragged,
                                    step=step)
        return self._decode_layers(params, tok, pools, step.pos, attn_fn)

    def _prefill_rows(self, prompt: np.ndarray):
        """Prefill one request and lower its K/V to page rows: returns the
        request's first generated token id and a per-pool dict of
        ``(n_pref, row_width)`` row tensors, page ``k``'s row at index
        ``k``, ready to scatter whenever the scheduler lands that page.
        The rows are tensors of their own (never views of the prefill
        cache), so held rows survive any in-place pool update.  K/V slots
        past the prompt in its last page stay zero; every decode mask is
        ``idx <= pos``, so a stale slot is never read before the decode
        step that writes it.  On a mesh the prefill runs on
        ``ax.for_batch(1)`` (the row on every rank, its positions split)
        and its K/V is made whole (``_whole_prefill``)."""
        kv = self.kv_cfg
        plen = int(prompt.shape[0])
        n_pref = -(-plen // kv.page_len)
        tokens = torch.as_tensor(np.asarray(prompt)[None], dtype=torch.int64,
                                 device=self.device)
        ax = self.ax.for_batch(1)
        logits, cache = T.prefill(self.cfg, self.rc, self.params,
                                  self._my_rows(tokens, ax), ax=ax)
        logits = self._all_rows(logits, ax)
        first = int(logits[0, -1, :self.cfg.vocab_size].argmax())
        cache = self._whole_prefill(cache, plen, 1)

        def rows_of(kc):
            # kc: (1, t, KV, HD) with t ≤ plen (a sliding-window prefill
            # keeps only the window)
            t = kc.shape[1]
            buf = kc.new_zeros((1, n_pref * kv.page_len) + kc.shape[2:])
            buf[:, plen - t:plen] = kc
            return buf.reshape(n_pref, kv.row_width)

        rows = {}
        for j, _ in enumerate(self.cfg.block_pattern()):
            bc = cache["blocks"][f"b{j}"]
            for sb in range(self.cfg.n_superblocks):
                rows[f"b{j}s{sb}"] = {"k": rows_of(bc["k"][sb]),
                                      "v": rows_of(bc["v"][sb])}
        return first, rows

    def _scatter_rows(self, pools, rows, page_ids, page_start: int = 0):
        """Scatter one contiguous slice of held prefill rows into every
        layer's pools at the scheduler-allocated ids (one
        ``scatter_pages_pair`` call a layer): the live half of a prefill
        chunk, or with ``page_start=0`` and all ids of a whole-prompt
        admission."""
        (ids,) = self._upload(np.asarray(page_ids, np.int64))
        n = int(ids.shape[0])
        for key, pair in rows.items():
            k_pool, v_pool = KV.scatter_pages_pair(
                self.kv_cfg, pools[key]["k"], pools[key]["v"], ids,
                pair["k"][page_start:page_start + n],
                pair["v"][page_start:page_start + n])
            pools[key] = {"k": k_pool, "v": v_pool}
        return pools

    def _ingest_request(self, pools, prompt: np.ndarray, page_ids):
        """Whole-prompt admission: prefill and scatter every prompt page
        at once.  Returns the updated pools and the first token id."""
        first, rows = self._prefill_rows(prompt)
        return self._scatter_rows(pools, rows, page_ids), first

    def _migrate_pages(self, pools, old_ids, new_ids):
        """Evacuate a dying bank's live pages: in every layer, one paired
        gather reads the K and V rows of the old ids in full, then one
        paired scatter writes them to the new ids on surviving banks (old
        and new ids are distinct, so no row is read after it is written).
        The data is kept, and the live traffic is the ``fault_migrate``
        trace block the scheduler emitted."""
        kv = self.kv_cfg
        old, new = self._upload(np.asarray(old_ids, np.int64),
                                np.asarray(new_ids, np.int64))
        for key, pair in pools.items():
            k_rows, v_rows = KV.gather_pages_pair(kv, pair["k"], pair["v"],
                                                  old)
            k_pool, v_pool = KV.scatter_pages_pair(kv, pair["k"], pair["v"],
                                                   new, k_rows, v_rows)
            pools[key] = {"k": k_pool, "v": v_pool}
        return pools

    def _lose_page(self, pools, pid: int) -> None:
        """Zero logical page ``pid``'s line (its bank-major physical row) in
        every K and V pool, in place: the data an ECC fault destroys."""
        row = int(self.kv_cfg.layout.physical_row(pid, self.kv_cfg.n_pages))
        for pair in pools.values():
            for pool in pair.values():
                pool[row] = 0

    def _recover_page(self, pools, rec, toks, lane_tok, scratch: int):
        """Rebuild a corrupted page: zero its line in every pool (the data
        is lost; this is the ECC path, not a migration), re-prefill the
        victim's prompt pages, then replay its completed decode steps with
        the recorded tokens, each at the full lane batch with only the
        victim's lane active, so every step runs at the original step's
        shapes.  Every replayed token is held to the original: a recovery
        that diverges raises ``RuntimeError``."""
        r = rec["request"]
        rid, lane = rec["rid"], rec["lane"]
        self._lose_page(pools, int(rec["pid"]))
        pools, first = self._ingest_request(
            pools, np.asarray(r.tokens, np.int32), rec["prompt_ids"])
        seq = toks[rid]
        if seq and first != seq[0]:
            raise RuntimeError(
                f"recovery diverged for request {rid}: re-prefill produced "
                f"token {first}, original was {seq[0]}")
        plen = int(rec["plen"])
        act = np.zeros(self.max_batch, bool)
        act[lane] = True
        for j in range(int(rec["steps"])):
            pos = np.asarray(rec["pos"]).copy()
            pos[lane] = plen + j
            lt = lane_tok.copy()
            lt[lane] = seq[j]
            logits, pools = self._scheduler_step(
                self.params, lt, pools, rec["page_table"], pos, act,
                scratch)
            got = int(logits[lane, -1, :self.cfg.vocab_size].argmax())
            if got != int(seq[j + 1]):
                raise RuntimeError(
                    f"recovery diverged for request {rid} at replay step "
                    f"{j}: decoded {got}, original was {int(seq[j + 1])}")
        return pools

    def run_scheduler(self, requests, policy="seq-skew", scheduler=None,
                      fault_plan=None, guard=None, checkpoint_dir=None,
                      resume_from=None,
                      prefill_chunk_pages=None) -> SchedulerRunResult:
        """Continuous-batching generation: drive lane-ragged decode steps
        from ``scheduler.Scheduler`` (greedy sampling).

        The scheduler that picks lanes and allocates pages also emits the
        run's ``AddressTrace`` blocks, and this loop feeds the
        scheduler's own page-table / position / active snapshots to the
        step, so the recorded live trace (``scheduler_stream()``) is
        bit-equal to ``scheduler.simulate_scheduler_stream`` on the same
        traffic by construction.

        ``prefill_chunk_pages=N`` enables chunked prefill: the prompt's
        K/V rows are computed once at admission, held, and scattered chunk
        by chunk as the scheduler's ``ev.prefill_chunks`` records land the
        pages, while other lanes keep decoding.

        ``fault_plan`` injects a seeded ``runtime.FaultPlan``: before a
        tick's admissions, bank losses migrate live pages through the
        paired row kernels (``_migrate_pages``) and corrupted pages are
        re-prefilled and replayed with every token held to the original
        (``_recover_page``); a transient decode fault raises before any
        device work and the step is retried through
        ``runtime.retry_step``.  A ``preempt`` event, or a tripped
        ``runtime.PreemptionGuard`` (``guard``), checkpoints the pools,
        the lanes' tokens and the scheduler's state to ``checkpoint_dir``
        after the tick's physics (``repro_torch.checkpoint``, the
        reference's format; the save copies every pool to the host) and
        returns ``preempted=True`` with the checkpoint's path; without
        ``checkpoint_dir`` it raises ``ValueError``.  Pass the directory
        back as ``resume_from`` (with ``requests=None`` and the same
        ``fault_plan`` and ``prefill_chunk_pages``) to finish the day with
        the tokens of an uninterrupted run; lanes preempted mid-prefill
        re-derive their held rows from the request's tokens.
        ``scheduler_stream()`` then holds this call's half of the day.

        Requests need prompt ``tokens``.  The live path needs an
        attention-only model.  Each tick costs one host-to-device copy (the
        step's indices, pinned) and one read of the sampled tokens.  On a
        mesh every rank runs the same day on its whole pools (module
        docstring); the ranks agree on a guard's stop, rank 0 writes the
        checkpoint and every rank restores it."""
        from repro_torch.checkpoint import (latest_step, load_aux,
                                            restore_checkpoint)
        from repro_torch.runtime import TransientFault, retry_step
        from repro_torch.serving.scheduler import Scheduler
        if self.kv_mode != "paged":
            raise ValueError("run_scheduler requires kv_mode='paged'")
        if any(kind != "attn" for kind, _ in self.cfg.block_pattern()):
            raise NotImplementedError(
                "run_scheduler supports attention-only models (per-lane "
                "SSM state eviction/re-admission is not implemented); "
                "hybrid traffic can still be simulated and costed via "
                "scheduler.simulate_scheduler_stream")
        if resume_from is not None and requests is not None:
            raise ValueError("pass requests=None when resuming: the "
                             "checkpointed scheduler still holds them")
        sched = scheduler or Scheduler(
            self.kv_cfg, n_lanes=self.max_batch, max_seq=self.max_seq,
            policy=policy, n_kv_layers=self.n_kv_layers,
            fault_plan=fault_plan, prefill_chunk_pages=prefill_chunk_pages)
        kv = self.kv_cfg
        dtype = getattr(torch, self.rc.compute_dtype)
        scratch = sched.scratch_page or 0
        lane_tok = np.zeros(self.max_batch, np.int64)
        lane_rid = np.full(self.max_batch, -1, np.int64)
        toks: dict[int, list] = {}
        outputs: dict[int, np.ndarray] = {}
        #: held prefill rows of lanes mid-chunked-prefill (lane -> rows)
        pending: dict[int, dict] = {}
        self._sched_traces = []
        preempted, ckpt_path = False, None
        with torch.inference_mode():
            pools = {
                f"b{j}s{sb}": {h: torch.zeros((kv.n_pages, kv.row_width),
                                              dtype=dtype, device=self.device)
                               for h in ("k", "v")}
                for j, _ in enumerate(self.cfg.block_pattern())
                for sb in range(self.cfg.n_superblocks)}
            if resume_from is not None:
                step = latest_step(resume_from)
                if step is None:
                    raise ValueError(f"no checkpoint found in {resume_from}")
                # the pools land on the engine's device; lane_tok travels
                # in the reference's (max_batch, 1) int32 and lands on the
                # host, where the port keeps it
                restored = restore_checkpoint(
                    resume_from, step,
                    {"pools": pools,
                     "lane_tok": torch.zeros((self.max_batch, 1),
                                             dtype=torch.int32)})
                pools = restored["pools"]
                lane_tok = restored["lane_tok"][:, 0].numpy().astype(
                    np.int64)
                aux = load_aux(resume_from, step)
                if aux is None:
                    raise ValueError(
                        f"checkpoint step {step} in {resume_from} has no "
                        f"scheduler sidecar (aux.json); was it written by "
                        f"run_scheduler?")
                sched.load_state(aux["sched"])
                toks = {int(k): [int(t) for t in v]
                        for k, v in aux["toks"].items()}
                outputs = {int(k): np.asarray(v, np.int32)
                           for k, v in aux["outputs"].items()}
                lane_rid = np.asarray(aux["lane_rid"], np.int64)
                # lanes checkpointed mid-chunked-prefill: their landed
                # chunks are in the restored pools; the held rows are
                # recomputed from the request's tokens (prefill is
                # deterministic, so the remaining chunks scatter the rows
                # an uninterrupted run would)
                for lane in sched._prefill_next:
                    r = sched._by_rid[int(sched.lane_rid[lane])]
                    _, pending[lane] = self._prefill_rows(
                        np.asarray(r.tokens, np.int32))
            for ev in sched.run(requests):
                for mig in ev.migrations:
                    if mig["old_ids"]:
                        pools = self._migrate_pages(pools, mig["old_ids"],
                                                    mig["new_ids"])
                for rec in ev.recoveries:
                    if not rec["skipped"]:
                        pools = self._recover_page(pools, rec, toks,
                                                   lane_tok, scratch)
                for c in ev.completed:
                    outputs[c.request.rid] = np.asarray(
                        toks.pop(c.request.rid, []), np.int32)
                    lane_rid[c.lane] = -1
                    pending.pop(c.lane, None)    # cancelled mid-prefill
                for adm in ev.admitted:
                    r = adm.request
                    if r.tokens is None:
                        raise ValueError(
                            f"request {r.rid} has no prompt tokens; "
                            f"synthesize with vocab_size= or attach tokens "
                            f"for live runs")
                    prompt = np.asarray(r.tokens, np.int32)
                    if sched.prefill_chunk_pages is None:
                        pools, first = self._ingest_request(pools, prompt,
                                                            adm.page_ids)
                    else:
                        # chunked admission: prefill now, hold the page
                        # rows; the chunk records (chunk 0 included)
                        # scatter them as the scheduler lands the pages
                        first, pending[adm.lane] = self._prefill_rows(prompt)
                    lane_rid[adm.lane] = r.rid
                    toks[r.rid] = [first] if r.max_new_tokens >= 1 else []
                    lane_tok[adm.lane] = first
                for chunk in ev.prefill_chunks:
                    pools = self._scatter_rows(pools, pending[chunk["lane"]],
                                               chunk["page_ids"],
                                               chunk["page_start"])
                    if chunk["done"]:
                        del pending[chunk["lane"]]
                if ev.decoded:
                    args = (self.params, lane_tok, pools, ev.page_table,
                            ev.pos, ev.active, scratch)
                    if ev.transients:
                        # injected transient faults: the step fails
                        # ``transients`` times, before any device work, so
                        # the in-place pools are never half-written, and
                        # the retry path absorbs every failure
                        budget = [ev.transients]

                        def flaky(tick=ev.tick):
                            if budget[0] > 0:
                                budget[0] -= 1
                                raise TransientFault(
                                    f"injected decode fault at tick {tick}")
                            return self._scheduler_step(*args)

                        logits, pools = retry_step(
                            flaky, retries=ev.transients, backoff=1e-6,
                            retry_on=(TransientFault,),
                            _sleep=lambda s: None)
                    else:
                        logits, pools = self._scheduler_step(*args)
                    nxt = logits[:, -1, :self.cfg.vocab_size].argmax(-1)
                    nxt = nxt.cpu().numpy()     # the step's one device sync
                    lane_tok = np.where(ev.active, nxt, lane_tok)
                    for lane in np.flatnonzero(ev.active):
                        toks[int(lane_rid[lane])].append(int(nxt[lane]))
                self._sched_traces.extend(ev.traces)
                if ev.preempt or (guard is not None
                                  and self._any_rank(guard.should_stop)):
                    if checkpoint_dir is None:
                        raise ValueError(
                            "preemption fired but run_scheduler has no "
                            "checkpoint_dir to drain into")
                    aux = {"sched": sched.state_dict(),
                           "toks": {str(k): [int(t) for t in v]
                                    for k, v in toks.items()},
                           "outputs": {str(k): np.asarray(v).tolist()
                                       for k, v in outputs.items()},
                           "lane_rid": lane_rid.tolist()}
                    # the save copies every pool to the host: the sync
                    ckpt_path = self._save(
                        checkpoint_dir, sched.now,
                        {"pools": pools,
                         "lane_tok": torch.from_numpy(
                             lane_tok.astype(np.int32)[:, None])},
                        aux)
                    preempted = True
                    break
        self.last_pools = pools
        self._sched_meta = {"what": "scheduler-live",
                            "arch": self.mem_arch.name,
                            "policy": sched.policy_name,
                            "n_requests": len(outputs), "ticks": sched.now}
        return SchedulerRunResult(outputs=outputs, stats=sched.stats(),
                                  ticks=sched.now, preempted=preempted,
                                  checkpoint=ckpt_path)

    def _any_rank(self, flag: bool) -> bool:
        """Whether any rank's ``flag`` is set (every rank must stop at the
        same tick); off a mesh ``flag``."""
        if self.ax.mesh is None:
            return flag
        t = torch.tensor([int(flag)], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def _save(self, directory: str, step: int, state, aux) -> str:
        """``save_checkpoint``; on a mesh, where every rank holds the same
        whole pools, rank 0 writes and the others wait for it.  Returns
        the checkpoint's path."""
        from repro_torch.checkpoint import save_checkpoint
        if self.ax.mesh is None:
            return save_checkpoint(directory, step, state, aux=aux)
        path = os.path.join(directory, f"step_{step:08d}")
        if dist.get_rank() == 0:
            path = save_checkpoint(directory, step, state, aux=aux)
        dist.barrier()
        return path

    def scheduler_stream(self):
        """The last ``run_scheduler``'s KV traffic as a re-iterable
        ``TraceStream`` of the recorded per-tick blocks (bit-equal to the
        simulated lowering of the same traffic)."""
        from repro_torch.core.trace import TraceStream
        if not self._sched_traces:
            raise RuntimeError("no scheduler traces; run run_scheduler()")
        return TraceStream(list(self._sched_traces),
                           meta=dict(self._sched_meta))

    def scheduler_cost(self, archs=None, block_ops: int | None = None,
                       device=None):
        """Price the last ``run_scheduler`` traffic with ``cost_many`` (on
        the engine's device unless ``device`` says otherwise); ``archs``
        defaults to this engine's ``mem_arch`` (one ``TraceCost``), a list
        returns one ``TraceCost`` per entry."""
        return self._price(self.scheduler_stream(), archs, block_ops,
                           device)

    # -- dense reference path ----------------------------------------------

    def _pad_cache(self, cache, prompt_len: int, ax: Axes = NO_AXES):
        """Grow prefill attention caches (len = prompt) to the decode
        buffer (max_seq); ring (SWA) caches at window size stay as they
        are.  Only leaves named ``k`` / ``v`` are padded, as the reference
        picks them by path: SSM state (``h`` (n_superblocks, B, Di, N),
        ``conv`` (n_superblocks, B, K-1, Di)) is length-free, whatever its
        axis 2 happens to equal.  On a mesh (``ax``, the prefill's) each
        rank gathers its rows' positions, grows them and keeps its block
        of the decode cache, over ``layers.seq_axes(ax)``."""
        win = self.cfg.sliding_window
        seq = L.seq_axes(ax)

        def grow(j, name, x):
            if name not in ("k", "v"):
                return x
            t = self._prefill_positions(j, prompt_len)
            if ax.mesh is not None:
                x = gather_shard(x, (None, None, L.seq_axes(ax, t)), ax.mesh)
            if t == prompt_len and not (win and prompt_len == win):
                pad = x.new_zeros(x.shape[:2] + (self.max_seq - prompt_len,)
                                  + x.shape[3:])
                x = torch.cat([x, pad], dim=2)
            if not seq:
                return x
            n = shard_index(seq, ax.mesh)[1]
            if x.shape[2] % n:
                raise ValueError(
                    f"a decode cache of {x.shape[2]} positions does not "
                    f"split over the mesh axes {seq} ({n} ranks)")
            return own_block(x, (None, None, seq), ax.mesh)
        return {"blocks": {key: {name: grow(int(key[1:]), name, x)
                                 for name, x in c.items()}
                           for key, c in cache["blocks"].items()}}

    # -- generation --------------------------------------------------------

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 temperature: float = 0.0,
                 seed: int = 0) -> GenerationResult:
        """prompts: (B, prompt_len) integer token ids (a padded batch; on a
        mesh the whole batch, on every rank, which returns every token)."""
        b, plen = prompts.shape
        if b > self.max_batch or plen + max_new_tokens > self.max_seq:
            raise ValueError(f"batch {b} x {plen}+{max_new_tokens} tokens "
                             f"exceeds the engine's {self.max_batch} x "
                             f"{self.max_seq}")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        ax = self.ax.for_batch(b)
        with torch.inference_mode():
            tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                     device=self.device)
            logits, cache = T.prefill(self.cfg, self.rc, self.params,
                                      self._my_rows(tokens, ax), ax=ax)
            tok = self._sample(self._all_rows(logits, ax)[:, -1],
                               temperature, gen)
            out = [tok]
            paged = self.kv_mode == "paged"
            if paged:
                pools, pages = self._ingest_prefill(cache, plen, b)
                del cache                   # no dense KV survives prefill
                self._step_traces = []
                self._prefill_trace = KV.prefill_trace(
                    self.kv_cfg, pages.page_table, plen, self.n_kv_layers)
            else:
                cache = self._pad_cache(cache, plen, ax)
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
                        self.cfg, self.rc, self.params,
                        self._my_rows(tok, ax), cache,
                        torch.tensor(pos, device=self.device), ax=ax)
                    logits = self._all_rows(logits, ax)
                tok = self._sample(logits[:, -1], temperature, gen)
                out.append(tok)
            if paged:
                self.last_pages, self.last_pools = pages, pools
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
        return self._price(self.serving_stream(include_prefill), archs,
                           block_ops, device)

    def _price(self, stream, archs, block_ops, device):
        """``cost_many`` of a recorded stream on ``device`` (default the
        engine's): one ``TraceCost`` for ``mem_arch`` when ``archs`` is
        None, else one per entry."""
        from repro_torch.core.cost_engine import cost_many
        device = self.device if device is None else device
        costs = cost_many([self.mem_arch] if archs is None else list(archs),
                          stream, block_ops=block_ops, device=device)
        return costs[0] if archs is None else costs

    def _trace_chunks(self, include_prefill: bool) -> list:
        chunks = list(self._step_traces)
        if include_prefill and self._prefill_trace is not None:
            chunks = [self._prefill_trace] + chunks
        if not chunks:
            raise RuntimeError(
                "no traces recorded; run generate() with kv_mode='paged'")
        return chunks
