"""Banked paged KV cache (port of ``repro.serving.kvcache``): the paper's
shared-memory banking applied to serving state.

Pages are the banked unit.  Each KV layer's pool is a 2-D tensor of page
lines stored *bank-major* (physical page ``bank · pages_per_bank + slot``,
the ``BankedLayout`` of ``repro_torch.core.arch``).  A page table maps
(sequence, in-sequence page) → *logical pool page id*, minted with the
inverse bank map, so that

  * ``banked_gather`` / ``banked_scatter`` resolve the id to the physical
    page through the same row math, and
  * the cost model's bank maps see the bank the allocator placed the page
    in.

Allocation is the carry-chain arbiter at page granularity
(``allocate_pages``); the trace path (``decode_step_trace``,
``prefill_trace``, ``simulate_serving_stream``) lowers the same request
streams to ``AddressTrace``s for ``cost_many``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.arbiter import grant_positions
from repro_torch.core.conflicts import bank_counts

__all__ = [
    "PagedKVConfig", "PageTableState", "pool_pages", "init_pages",
    "allocate_pages", "bank_load_stats", "gather_pages",
    "scatter_pages", "kv_read_stream", "decode_step_trace", "prefill_trace",
    "simulate_serving_trace", "simulate_serving_stream", "ALLOC_POLICIES",
    "preferred_banks", "resolve_policy",
]

#: preferred-bank policies ``(map_bank, seq_key, n_banks) -> bank``:
#: ``"paper"`` — every sequence prefers the bank map of its page index;
#: ``"seq-skew"`` — rotated by the sequence key, so same-index pages of
#: concurrent sequences land in different banks.
ALLOC_POLICIES = {
    "paper": lambda bank, seq_key, n_banks: bank,
    "seq-skew": lambda bank, seq_key, n_banks: (bank + seq_key) % n_banks,
}


def resolve_policy(policy):
    """A policy name or callable -> the ``(bank, seq_key, n_banks) -> bank``
    callable."""
    if callable(policy):
        return policy
    try:
        return ALLOC_POLICIES[policy]
    except KeyError:
        raise ValueError(
            f"unknown allocation policy {policy!r}; choose from "
            f"{tuple(ALLOC_POLICIES)} or pass a callable") from None


def preferred_banks(layout, page_idx, seq_key, policy="paper"):
    """The bank each (sequence, in-sequence page index) request prefers."""
    bank, _ = layout.bank_slot(page_idx)
    return resolve_policy(policy)(bank, seq_key, layout.n_banks)


def pool_pages(n_banks: int, batch: int, max_seq: int, page_len: int,
               slack: int = 2) -> int:
    """Physical pool size: ``slack``× the worst-case live pages of a
    (batch, max_seq) budget, rounded up to a whole number of banks."""
    pages_per_seq = -(-max_seq // page_len)
    n = slack * batch * pages_per_seq
    return -(-n // n_banks) * n_banks


@dataclass(frozen=True)
class PagedKVConfig:
    n_pages: int            # physical pool size (multiple of n_banks)
    page_len: int           # tokens per page
    n_banks: int = 16
    mapping: str = "lsb"
    kv_heads: int = 8
    head_dim: int = 128
    map_shift: int = 2      # offset-map bank-bit position

    @classmethod
    def from_arch(cls, arch, n_pages: int, page_len: int,
                  kv_heads: int = 8, head_dim: int = 128) -> "PagedKVConfig":
        """Derive the page-pool banking from a ``MemoryArchitecture`` (name,
        spec or object)."""
        from repro_torch.core import arch as _arch
        a = _arch.resolve(arch)
        lay = a.layout
        if lay is None:
            raise ValueError(
                f"{a.name} has no banked layout to derive a KV page map "
                f"from; use a banked architecture (e.g. '16B-offset')")
        return cls(n_pages=n_pages, page_len=page_len, n_banks=lay.n_banks,
                   mapping=lay.mapping, kv_heads=kv_heads, head_dim=head_dim,
                   map_shift=lay.shift)

    @property
    def layout(self):
        from repro_torch.core.arch import BankedLayout
        return BankedLayout(self.n_banks, self.mapping, self.map_shift)

    @property
    def pages_per_bank(self) -> int:
        return self.n_pages // self.n_banks

    @property
    def row_width(self) -> int:
        """Elements per page line in the 2-D kernel view of the pool."""
        return self.page_len * self.kv_heads * self.head_dim


class PageTableState(NamedTuple):
    """Allocation state.  ``page_table`` holds logical pool page ids (-1 =
    unmapped): the addresses the kernels and the cost model consume."""
    page_table: torch.Tensor   # (B, max_pages) int64 logical ids
    seq_lens: torch.Tensor     # (B,) int64 tokens written per sequence
    bank_used: torch.Tensor    # (n_banks,) int64 allocated pages per bank


def init_pages(cfg: PagedKVConfig, batch: int, max_seq: int,
               device="cuda") -> PageTableState:
    if cfg.n_pages % cfg.n_banks:
        raise ValueError(f"{cfg.n_pages} pages not divisible by "
                         f"{cfg.n_banks} banks")
    max_pages = -(-max_seq // cfg.page_len)
    return PageTableState(
        page_table=torch.full((batch, max_pages), -1, dtype=torch.int64,
                              device=device),
        seq_lens=torch.zeros((batch,), dtype=torch.int64, device=device),
        bank_used=torch.zeros((cfg.n_banks,), dtype=torch.int64,
                              device=device))


def allocate_pages(cfg: PagedKVConfig, state: PageTableState,
                   need: torch.Tensor, policy="paper"
                   ) -> tuple[PageTableState, torch.Tensor]:
    """Allocate one page for every sequence with need[b] true, on the
    state's device.

    Phase 1 (the arbiter): preferred bank = ``policy`` of the bank map of
    the in-sequence page index; grant order = exclusive count per bank;
    grants within the bank's free capacity succeed.  Phase 2 (capacity
    spill): the rest take slots from the global free list, least-loaded
    banks first (stable sort: ties go to the lowest bank index).

    Returns (new state, (B,) logical pool page ids or -1); the id is
    ``BankedLayout.logical_row(bank, slot)``."""
    b = need.shape[0]
    dev = need.device
    cap = cfg.pages_per_bank
    lay = cfg.layout
    lanes = torch.arange(b, device=dev)
    logical = state.seq_lens // cfg.page_len            # next in-seq page
    pref_bank = preferred_banks(lay, logical, lanes, policy)
    need_i = need.to(torch.int64)

    # phase 1: arbiter grants at the preferred bank
    pos1 = grant_positions(pref_bank, cfg.n_banks, mask=need_i)
    slot1 = state.bank_used[pref_bank] + pos1
    ok1 = need & (slot1 < cap)
    used1 = state.bank_used + bank_counts(pref_bank, cfg.n_banks, mask=ok1)

    # phase 2: spill to the global free list (least-loaded banks first)
    overflow = need & ~ok1
    rank = torch.cumsum(overflow.to(torch.int64), 0) - overflow.to(
        torch.int64)
    order = torch.argsort(used1, stable=True)
    free_sorted = (cap - used1)[order]
    cum = torch.cumsum(free_sorted, 0)
    sidx = torch.searchsorted(cum, rank, right=True)
    sidx_c = sidx.clamp(0, cfg.n_banks - 1)
    bank2 = order[sidx_c]
    prev = cum[sidx_c] - free_sorted[sidx_c]
    slot2 = used1[bank2] + (rank - prev)
    ok2 = overflow & (rank < cum[-1]) & (slot2 < cap)

    bank = torch.where(ok1, pref_bank, bank2)
    slot = torch.where(ok1, slot1, slot2)
    ok = ok1 | ok2
    page_id = torch.where(ok, lay.logical_row(bank, slot), -1)

    new_used = state.bank_used + bank_counts(bank, cfg.n_banks, mask=ok)
    pt = state.page_table.clone()
    pt[lanes, logical] = torch.where(ok, page_id, pt[lanes, logical])
    return PageTableState(pt, state.seq_lens, new_used), page_id


def bank_load_stats(state) -> dict:
    """Paper-style bank efficiency of the allocation plus occupancy skew:
    ``max`` / ``min`` / ``mean`` occupancy, ``serialization`` (max/mean),
    ``max_min_ratio`` (min clamped to 1 page) and ``mad`` (mean absolute
    deviation).  Accepts a ``PageTableState`` or a per-bank vector."""
    used = getattr(state, "bank_used", state)
    used = torch.as_tensor(used).float()
    mean = used.mean()
    return {"max": used.max(), "min": used.min(), "mean": mean,
            "serialization": used.max() / torch.clamp(mean, min=1e-9),
            "max_min_ratio": used.max() / torch.clamp(used.min(), min=1.0),
            "mad": (used - mean).abs().mean()}


# --------------------------------------------------------------------------
# kernel path (the serving hot path: registry kernels on a bank-major pool)
# --------------------------------------------------------------------------

def gather_pages(arch, cfg: PagedKVConfig, pool2d: torch.Tensor,
                 page_ids: torch.Tensor) -> torch.Tensor:
    """Gather page lines by logical pool page id through the
    ``banked_gather`` kernel (persistent bank-major pool, no relayout).
    page_ids: (N,) int64, already clamped ≥ 0."""
    from repro_torch.kernels import registry
    return registry.get("banked_gather").run(arch, pool2d, page_ids,
                                             table_banked=True)


def scatter_pages(arch, cfg: PagedKVConfig, pool2d: torch.Tensor,
                  page_ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Scatter page lines into logical pool page ids through the
    ``banked_scatter`` kernel; updates the pool in place and returns it."""
    from repro_torch.kernels import registry
    return registry.get("banked_scatter").run(arch, pool2d, page_ids, rows,
                                              table_banked=True)


# --------------------------------------------------------------------------
# trace path (what the decode loop costs)
# --------------------------------------------------------------------------

def kv_read_stream(page_table) -> tuple[np.ndarray, np.ndarray]:
    """The decode-step read stream: every sequence requests its whole page
    list.  Returns (ids, active-lane mask) — unmapped (-1) entries are
    clamped to page 0 and predicated off."""
    pt = _np(page_table)
    return np.maximum(pt, 0).reshape(-1), (pt >= 0).reshape(-1)


def _np(page_table) -> np.ndarray:
    if isinstance(page_table, torch.Tensor):
        page_table = page_table.cpu().numpy()
    return np.asarray(page_table)


def decode_step_trace(cfg: PagedKVConfig, page_table, pos: int,
                      n_kv_layers: int = 1):
    """One decode step's exact ``AddressTrace``: per KV layer, in kernel
    call order, a K and a V page gather (the paged-attention read), then a
    K and a V scatter of each sequence's current page (the append)."""
    from repro_torch.core.trace import AddressTrace
    from repro_torch.kernels.banked_gather.ops import banked_gather_trace
    from repro_torch.kernels.banked_scatter.ops import banked_scatter_trace
    pt = _np(page_table)
    b = pt.shape[0]
    read_ids, read_mask = kv_read_stream(pt)
    cur = pt[np.arange(b), int(pos) // cfg.page_len]
    cur_ids, cur_mask = np.maximum(cur, 0), cur >= 0
    chunks = []
    for _ in range(n_kv_layers):
        for _kv in range(2):
            chunks.append(banked_gather_trace(None, None, read_ids,
                                              mask=read_mask))
        for _kv in range(2):
            chunks.append(banked_scatter_trace(None, None, cur_ids,
                                               mask=cur_mask))
    t = AddressTrace.concat(*chunks)
    t.meta.update({"what": "decode_step", "pos": int(pos),
                   "n_kv_layers": n_kv_layers})
    return t


def prefill_trace(cfg: PagedKVConfig, page_table, prompt_len: int,
                  n_kv_layers: int = 1):
    """The prefill ingest's ``AddressTrace``: one K and one V page scatter
    per layer covering every prompt page."""
    from repro_torch.core.trace import AddressTrace
    from repro_torch.kernels.banked_scatter.ops import banked_scatter_trace
    pt = _np(page_table)
    n_pref = -(-prompt_len // cfg.page_len)
    ids = pt[:, :n_pref]
    ids_flat, mask = np.maximum(ids, 0).reshape(-1), (ids >= 0).reshape(-1)
    chunks = []
    for _ in range(n_kv_layers):
        for _kv in range(2):
            chunks.append(banked_scatter_trace(None, None, ids_flat,
                                               mask=mask))
    t = AddressTrace.concat(*chunks)
    t.meta.update({"what": "prefill", "prompt_len": int(prompt_len),
                   "n_kv_layers": n_kv_layers})
    return t


def fill_prompt_pages(cfg: PagedKVConfig, batch: int, max_seq: int,
                      prompt_len: int, device="cuda") -> PageTableState:
    """Allocate every prompt page of a batch, page index by page index (the
    order the engine's prefill ingest and the simulation share), and set
    each sequence's length to the prompt."""
    state = init_pages(cfg, batch, max_seq, device)
    ones = torch.ones((batch,), dtype=torch.bool, device=device)
    for p in range(-(-prompt_len // cfg.page_len)):
        state = state._replace(seq_lens=torch.full(
            (batch,), p * cfg.page_len, dtype=torch.int64, device=device))
        state, _ = allocate_pages(cfg, state, ones)
    return state._replace(seq_lens=torch.full(
        (batch,), prompt_len, dtype=torch.int64, device=device))


def simulate_serving_stream(arch, batch: int, prompt_len: int,
                            decode_steps: int, page_len: int = 8,
                            n_kv_layers: int = 1, max_seq: int | None = None,
                            include_prefill: bool = True, device="cuda"):
    """The serving traffic of a (batch, context) point as a lazy,
    re-iterable ``TraceStream``: one source block per prefill ingest /
    decode step, with pages allocated (on ``device``) by the same arbiter
    the live engine uses.  Non-banked architectures price the canonical
    16-bank lsb pool's stream."""
    from repro_torch.core import arch as _arch
    from repro_torch.core.trace import TraceStream
    a = _arch.resolve(arch)
    max_seq = max_seq or (prompt_len + decode_steps)
    if a.layout is not None:
        cfg = PagedKVConfig.from_arch(
            a, n_pages=pool_pages(a.layout.n_banks, batch, max_seq, page_len),
            page_len=page_len, kv_heads=1, head_dim=1)
    else:
        cfg = PagedKVConfig(
            n_pages=pool_pages(16, batch, max_seq, page_len),
            page_len=page_len, n_banks=16, mapping="lsb", kv_heads=1,
            head_dim=1, map_shift=1)

    def blocks():
        state = fill_prompt_pages(cfg, batch, max_seq, prompt_len, device)
        if include_prefill:
            yield prefill_trace(cfg, state.page_table, prompt_len,
                                n_kv_layers)
        for i in range(decode_steps):                   # decode appends
            pos = prompt_len + i
            need = (state.seq_lens % page_len) == 0
            state, _ = allocate_pages(cfg, state, need)
            yield decode_step_trace(cfg, state.page_table, pos, n_kv_layers)
            state = state._replace(seq_lens=state.seq_lens + 1)

    return TraceStream(blocks, meta={
        "what": "serving", "arch": a.name, "batch": batch,
        "prompt_len": prompt_len, "decode_steps": decode_steps,
        "page_len": page_len, "n_kv_layers": n_kv_layers})


def simulate_serving_trace(arch, batch: int, prompt_len: int,
                           decode_steps: int, page_len: int = 8,
                           n_kv_layers: int = 1, max_seq: int | None = None,
                           include_prefill: bool = True, device="cuda"):
    """The dense ``AddressTrace`` of ``simulate_serving_stream``."""
    return simulate_serving_stream(
        arch, batch, prompt_len, decode_steps, page_len=page_len,
        n_kv_layers=n_kv_layers, max_seq=max_seq,
        include_prefill=include_prefill,
        device=device).materialize()  # lint: allow-materialize
