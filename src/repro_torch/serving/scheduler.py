"""Continuous-batching, multi-tenant serving on the banked page pools (port
of ``repro.serving.scheduler``).

The fixed-batch ``ServeEngine.generate`` decodes one padded batch in
lockstep.  Continuous batching keeps many resident contexts and admits,
decodes and retires them lane by lane; this module is its control plane,
all host numpy:

  * ``Request``              — one tenant's job: arrival tick, prompt
    length, token budget (and, for live runs, the prompt token ids);
  * ``PagePool``             — a free-bitmap page allocator with a
    pluggable preferred-bank policy (``kvcache.ALLOC_POLICIES``): frees
    return pages to their bank, first-free scan inside the preferred bank,
    deterministic least-loaded spill across banks;
  * ``Scheduler``            — the lane state machine: per-lane sequence
    positions, FCFS admission of arrived requests into freed lanes,
    completion/cancellation that returns pages to the pool, chunked
    prefill, and one ``AddressTrace`` block per prefill ingest / ragged
    decode step;
  * ``simulate_scheduler_stream`` — a whole serving day lowered to the
    lazy ``TraceStream`` protocol (re-iterable, O(block) host memory),
    priced by ``cost_many`` like any Table II/III kernel;
  * ``synthesize_requests``  — seeded arrival-rate × context-distribution
    traffic (the ``bench.scheduler_workload`` sweep axes).

``ServeEngine.run_scheduler`` drives the same ``Scheduler`` against the
model and records the very trace blocks the simulation emits, so live and
simulated lowering are bit-equal by construction.

``policy="seq-skew"`` rotates each sequence's preferred bank by its
request id, so same-index pages of different tenants spread across banks
instead of all preferring the bank map of their page index.

A seeded ``runtime.FaultPlan`` injects faults at the start of their tick,
in live and simulated runs alike: a ``bank_offline`` evicts the bank's
live pages and migrates them to surviving banks (``fault_migrate_trace``),
a ``page_corrupt`` re-prefills its victim and replays its decode steps, a
``decode_transient`` asks the live engine to retry the tick's step, and a
``preempt`` marks the tick, after whose physics the live engine
checkpoints the pools and this scheduler's ``state_dict`` and returns.  A
``runtime.StepWatchdog`` may time the decode steps.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator

import numpy as np

from repro_torch.runtime.faults import FaultEvent, FaultPlan
from repro_torch.serving.kvcache import (PagedKVConfig, kv_read_stream,
                                         pool_pages, resolve_policy)

__all__ = [
    "Request", "Admission", "Completion", "TickEvent",
    "PagePool", "Scheduler",
    "scheduler_step_trace", "admission_prefill_trace",
    "fault_migrate_trace",
    "simulate_scheduler_stream", "synthesize_requests",
    "scheduler_pool_config", "total_new_tokens", "CONTEXT_DISTS",
]

# --------------------------------------------------------------------------
# requests and traffic synthesis
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Request:
    """One tenant's serving job.

    ``arrival`` is in scheduler ticks (one tick = one lane-ragged decode
    step of the whole engine).  ``max_new_tokens`` may be 0: the request
    still prefills (allocates, writes and frees its prompt pages) but
    generates nothing.  ``tokens`` carries the prompt ids for live
    ``ServeEngine.run_scheduler`` runs; trace-only simulation ignores it.
    """
    rid: int
    arrival: int
    prompt_len: int
    max_new_tokens: int
    tokens: np.ndarray | None = None

    def __post_init__(self):
        if self.prompt_len < 1:
            raise ValueError(f"request {self.rid}: prompt_len must be >= 1")
        if self.max_new_tokens < 0:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 0")

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


#: named context-length distributions for ``synthesize_requests``: each
#: maps the day's ``max_seq`` budget to (prompt_len, max_new) samplers,
#: drawn from the caller's seeded Generator, so a (dist, seed, n_requests,
#: arrival_rate) tuple names one exact serving day
CONTEXT_DISTS: dict[str, Callable] = {
    # short interactive turns: small prompts, small completions
    "short": lambda rng, cap: (int(rng.integers(4, max(5, cap // 8))),
                               int(rng.integers(1, max(2, cap // 16)))),
    # long-context summarization: big prompts, modest completions
    "long": lambda rng, cap: (int(rng.integers(cap // 2, 3 * cap // 4)),
                              int(rng.integers(1, max(2, cap // 8)))),
    # mixed tenancy: 70 % short turns, 30 % long-context jobs
    "mixed": lambda rng, cap: (CONTEXT_DISTS["short"](rng, cap)
                               if rng.random() < 0.7
                               else CONTEXT_DISTS["long"](rng, cap)),
}


def synthesize_requests(n_requests: int, arrival_rate: float = 1.0,
                        context_dist: str = "mixed", max_seq: int = 256,
                        seed: int = 0, vocab_size: int | None = None
                        ) -> list[Request]:
    """A seeded serving day: ``n_requests`` jobs with exponential
    inter-arrival times (mean ``1/arrival_rate`` ticks) and context lengths
    drawn from a named ``CONTEXT_DISTS`` entry, clamped to ``max_seq``.
    ``vocab_size`` also draws prompt token ids (live runs need them)."""
    if context_dist not in CONTEXT_DISTS:
        raise ValueError(f"unknown context_dist {context_dist!r}; choose "
                         f"from {tuple(CONTEXT_DISTS)}")
    if arrival_rate <= 0:
        raise ValueError(f"arrival_rate must be > 0, got {arrival_rate}")
    rng = np.random.default_rng(seed)
    sample = CONTEXT_DISTS[context_dist]
    out, t = [], 0.0
    for rid in range(n_requests):
        t += rng.exponential(1.0 / arrival_rate)
        plen, new = sample(rng, max_seq)
        plen = max(1, min(plen, max_seq - 1))
        new = max(0, min(new, max_seq - plen))
        tokens = (rng.integers(0, vocab_size, size=plen).astype(np.int32)
                  if vocab_size else None)
        out.append(Request(rid=rid, arrival=int(t), prompt_len=plen,
                           max_new_tokens=new, tokens=tokens))
    return out


def total_new_tokens(requests: Iterable[Request]) -> int:
    """Tokens the day generates (the ``us_per_token`` objective's
    denominator)."""
    return sum(r.max_new_tokens for r in requests)


# --------------------------------------------------------------------------
# the page pool: free-bitmap allocation with a preferred-bank policy
# --------------------------------------------------------------------------

class PagePool:
    """Host-side page allocator over one bank-major pool, with a full free
    bitmap so completed sequences return their pages.  Selection is
    deterministic:

      1. preferred bank = ``policy(bank_map(page_idx), seq_key, n_banks)``
         (``kvcache.ALLOC_POLICIES``);
      2. first-free slot scan inside that bank;
      3. on a full bank, spill to the least-loaded bank holding a free
         slot (ties break toward the lowest bank index), first-free slot.

    Ids are minted with ``BankedLayout.logical_row(bank, slot)``, so the
    arch's bank map on the id recovers exactly the chosen bank: the cost
    model and the row kernels agree with the allocator by construction.
    """

    def __init__(self, cfg: PagedKVConfig, policy="seq-skew",
                 reserve: Iterable[int] = ()):
        self.cfg = cfg
        self.layout = cfg.layout
        self.n_banks = cfg.n_banks
        self.pages_per_bank = cfg.pages_per_bank
        self.free = np.ones((self.n_banks, self.pages_per_bank), bool)
        self.bank_used = np.zeros(self.n_banks, np.int64)
        self.policy = resolve_policy(policy)
        self.offline: set[int] = set()                 # hard-failed banks
        self._where: dict[int, tuple[int, int]] = {}   # id -> (bank, slot)
        self._kbank = np.zeros(0, np.int64)            # bank_map(k) cache
        # (bank, slot) -> logical id, computed once: alloc is pure numpy
        self._pid = np.asarray(self.layout.logical_row(
            np.arange(self.n_banks)[:, None],
            np.arange(self.pages_per_bank)[None, :]), dtype=np.int64)
        for pid in reserve:
            bank, slot = (int(x) for x in
                          self.layout.bank_slot(np.asarray(pid)))
            if not self.free[bank, slot]:
                raise ValueError(f"page {pid} reserved twice")
            self.free[bank, slot] = False
            self.bank_used[bank] += 1

    def _map_bank(self, page_idx: int) -> int:
        """The arch's bank map on an in-sequence page index (cached)."""
        if page_idx >= self._kbank.shape[0]:
            ks = np.arange(max(page_idx + 1, 2 * len(self._kbank) + 8))
            self._kbank = np.asarray(self.layout.bank_slot(ks)[0],
                                     dtype=np.int64)
        return int(self._kbank[page_idx])

    @property
    def n_free(self) -> int:
        return int(self.free.sum())

    def alloc(self, page_idx: int, seq_key: int) -> int:
        """Allocate one page for in-sequence page index ``page_idx`` of
        sequence ``seq_key``; returns the logical pool page id.  Raises
        ``RuntimeError`` when the pool is exhausted."""
        bank = int(self.policy(self._map_bank(page_idx), seq_key,
                               self.n_banks))
        if not self.free[bank].any():
            open_banks = np.flatnonzero(self.free.any(axis=1))
            if open_banks.size == 0:
                raise RuntimeError(
                    f"page pool exhausted ({self.cfg.n_pages} pages)")
            bank = int(open_banks[np.argmin(self.bank_used[open_banks])])
        slot = int(np.argmax(self.free[bank]))          # first-free scan
        self.free[bank, slot] = False
        self.bank_used[bank] += 1
        pid = int(self._pid[bank, slot])
        self._where[pid] = (bank, slot)
        return pid

    def release(self, page_ids: Iterable[int]) -> None:
        """Return pages to the pool (completion / eviction path)."""
        for pid in page_ids:
            loc = self._where.pop(int(pid), None)
            if loc is None:
                raise ValueError(f"page {pid} is not allocated")
            bank, slot = loc
            self.free[bank, slot] = True
            self.bank_used[bank] -= 1

    def offline_bank(self, bank: int) -> list[int]:
        """Take a whole bank out of service (a hard memory fault).

        Every free slot in the bank becomes unavailable (``alloc`` never
        picks a bank with no free slot) and every live page on it leaves
        the allocation map without returning to the pool, so its id is
        never minted again.  Returns the evicted live page ids in ascending
        order; the caller migrates their data to newly allocated pages on
        surviving banks.  Idempotent: a second call for the bank returns
        []."""
        if not 0 <= bank < self.n_banks:
            raise ValueError(f"bank {bank} out of range "
                             f"[0, {self.n_banks})")
        if bank in self.offline:
            return []
        self.offline.add(bank)
        self.free[bank, :] = False
        live = sorted(p for p, (b, _) in self._where.items() if b == bank)
        for pid in live:
            del self._where[pid]
        return live

    # -- serialization -----------------------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable allocator state (``Scheduler.state_dict``'s
        pool section); restore with ``load_state`` on a pool built from
        the same ``PagedKVConfig`` and reserve set."""
        return {
            "free": self.free.astype(int).tolist(),
            "bank_used": self.bank_used.tolist(),
            "where": {str(p): [int(b), int(s)]
                      for p, (b, s) in sorted(self._where.items())},
            "offline": sorted(self.offline),
        }

    def load_state(self, state: dict) -> None:
        free = np.asarray(state["free"], bool)
        if free.shape != self.free.shape:
            raise ValueError(
                f"pool shape mismatch: the state's free bitmap is "
                f"{free.shape}, this pool is {self.free.shape}")
        self.free = free
        self.bank_used = np.asarray(state["bank_used"], np.int64)
        self._where = {int(p): (int(b), int(s))
                       for p, (b, s) in state["where"].items()}
        self.offline = {int(b) for b in state["offline"]}


# --------------------------------------------------------------------------
# trace lowering of one ragged tick
# --------------------------------------------------------------------------

def admission_prefill_trace(cfg: PagedKVConfig, page_ids: np.ndarray,
                            n_kv_layers: int = 1, rid: int | None = None):
    """One admitted request's prefill ingest: a K and a V page scatter per
    KV layer covering the request's prompt pages (the per-request
    counterpart of ``kvcache.prefill_trace``)."""
    from repro_torch.core.trace import AddressTrace
    from repro_torch.kernels.banked_scatter.ops import banked_scatter_trace
    ids = np.asarray(page_ids, np.int32).reshape(-1)
    mask = np.ones(ids.shape[0], bool)
    chunks = []
    for _ in range(n_kv_layers):
        chunks.append(banked_scatter_trace(None, None, ids, mask=mask))
        chunks.append(banked_scatter_trace(None, None, ids, mask=mask))
    t = AddressTrace.concat(*chunks)
    t.meta.update({"what": "sched_prefill", "rid": rid,
                   "n_pages": int(ids.shape[0]), "n_kv_layers": n_kv_layers})
    return t


def fault_migrate_trace(cfg: PagedKVConfig, old_ids, new_ids,
                        n_kv_layers: int = 1, bank: int | None = None,
                        tick: int | None = None):
    """A bank-loss page migration's exact ``AddressTrace``: per KV layer, a
    K and a V gather of the dying bank's live pages, each followed by a
    scatter to their new homes on surviving banks.  Ordinary banked
    traffic: the cost model prices the evacuation burst with the conflict
    formula of any Table II/III kernel."""
    from repro_torch.core.trace import AddressTrace
    from repro_torch.kernels.banked_gather.ops import banked_gather_trace
    from repro_torch.kernels.banked_scatter.ops import banked_scatter_trace
    old = np.asarray(old_ids, np.int32).reshape(-1)
    new = np.asarray(new_ids, np.int32).reshape(-1)
    if old.shape != new.shape:
        raise ValueError(f"old/new page-id counts disagree "
                         f"({old.shape[0]} vs {new.shape[0]})")
    mask = np.ones(old.shape[0], bool)
    chunks = []
    for _ in range(n_kv_layers):
        for _kv in range(2):                           # K then V
            chunks.append(banked_gather_trace(None, None, old, mask=mask))
            chunks.append(banked_scatter_trace(None, None, new, mask=mask))
    t = AddressTrace.concat(*chunks)
    t.meta.update({"what": "fault_migrate", "bank": bank, "tick": tick,
                   "n_pages": int(old.shape[0]), "n_kv_layers": n_kv_layers})
    return t


def scheduler_step_trace(cfg: PagedKVConfig, page_table, pos, active,
                         n_kv_layers: int = 1, tick: int | None = None,
                         degraded: bool = False):
    """One lane-ragged decode step's exact ``AddressTrace``.

    ``kvcache.decode_step_trace`` with per-lane positions and an
    active-lane mask: per KV layer, a K- and a V-pool page-list gather
    (unmapped and inactive lanes predicated off) followed by a K and a V
    scatter of each active lane's *current* page (the read-modify-write
    append at the lane's own position).  Addresses are logical pool page
    ids.  ``degraded`` names the block as a step on a layout that has lost
    a bank.
    """
    from repro_torch.core.trace import AddressTrace
    from repro_torch.kernels.banked_gather.ops import banked_gather_trace
    from repro_torch.kernels.banked_scatter.ops import banked_scatter_trace
    pt = np.asarray(page_table)
    pos = np.asarray(pos)
    active = np.asarray(active, bool)
    b = pt.shape[0]
    read_ids, read_mask = kv_read_stream(pt)
    read_mask = read_mask & np.repeat(active, pt.shape[1])
    cur = np.where(active, pt[np.arange(b),
                              np.minimum(pos // cfg.page_len,
                                         pt.shape[1] - 1)], -1)
    cur_ids, cur_mask = np.maximum(cur, 0), cur >= 0
    chunks = []
    for _ in range(n_kv_layers):
        chunks.append(banked_gather_trace(None, None, read_ids,
                                          mask=read_mask))
        chunks.append(banked_gather_trace(None, None, read_ids,
                                          mask=read_mask))
        chunks.append(banked_scatter_trace(None, None, cur_ids,
                                           mask=cur_mask))
        chunks.append(banked_scatter_trace(None, None, cur_ids,
                                           mask=cur_mask))
    t = AddressTrace.concat(*chunks)
    t.meta.update({"what": ("sched_decode_degraded" if degraded
                            else "sched_decode"), "tick": tick,
                   "active": int(active.sum()), "n_kv_layers": n_kv_layers})
    return t


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Admission:
    """A request entering a lane: its prompt pages are already allocated
    (``page_ids``, one per prompt page, in page order; with chunked
    prefill, the first chunk's)."""
    request: Request
    lane: int
    page_ids: np.ndarray


@dataclass(frozen=True)
class Completion:
    """A request leaving its lane (its pages are already back in the
    pool).  ``cancelled`` marks a mid-flight eviction via ``cancel``."""
    request: Request
    lane: int
    tick: int
    cancelled: bool = False


@dataclass
class TickEvent:
    """Everything one scheduler tick did, in order: completions freed
    lanes, prefill chunks landed, admissions filled lanes, then (if any
    lane is mid-generation) one lane-ragged decode step ran.  ``traces``
    holds the tick's ``AddressTrace`` blocks in emission order; their
    concatenation over a run is the day's serving trace."""
    tick: int
    admitted: list = field(default_factory=list)
    completed: list = field(default_factory=list)
    traces: list = field(default_factory=list)
    #: chunked-prefill ingests this tick, in emission order and including
    #: the admission tick's first chunk: one record {rid, lane, page_ids,
    #: page_start, done} per chunk.  The live run scatters exactly these
    #: page rows; ``done`` marks the chunk that completes the prompt.
    prefill_chunks: list = field(default_factory=list)
    decoded: bool = False
    page_table: np.ndarray | None = None    # decode-time snapshot (B, P)
    pos: np.ndarray | None = None           # (B,) pre-increment positions
    active: np.ndarray | None = None        # (B,) decoding lanes
    #: fault and recovery records of this tick (``FaultPlan`` injection):
    #: ``migrations`` one per bank loss ({tick, bank, old_ids, new_ids,
    #: lanes, slots}); ``recoveries`` one per corrupted page ({tick, rid,
    #: lane, skipped} and, when not skipped, request, pid, plen, steps,
    #: prompt_ids, page_table, pos); ``transients`` the injected decode
    #: failures the live engine retries through; ``preempt`` marks a
    #: preemption (the live engine checkpoints after this tick).
    migrations: list = field(default_factory=list)
    recoveries: list = field(default_factory=list)
    transients: int = 0
    preempt: bool = False


class Scheduler:
    """The continuous-batching lane state machine (see the module
    docstring).

    One tick: (1) sequences whose token budget is spent, or that were
    ``cancel``-led, leave their lanes and return their pages; (2) lanes
    mid-prefill ingest their next chunk; (3) arrived requests are admitted
    FCFS into free lanes (lowest lane first), each allocating its prompt
    pages under the preferred-bank policy; (4) if any lane is
    mid-generation, one ragged decode step runs: lanes on a page boundary
    allocate their next page, the step's trace is emitted, and per-lane
    positions advance.  Idle gaps (no resident work, next arrival in the
    future) fast-forward without emitting anything.

    Token accounting matches ``ServeEngine.generate``: a request with
    budget m samples its first token from prefill and runs m-1 decode
    steps, so a lane's position counts KV-resident tokens.  m <= 1
    requests never decode: they hold the lane for the admission tick only
    and complete at the next tick's start.

    With ``prefill_chunk_pages=N`` a long prompt's admission is chunked:
    each tick ingests at most N prompt pages while other lanes keep
    decoding, and the lane joins the decode step on the tick its last
    chunk lands.  A prompt that fits one chunk is schedule-identical to
    whole-prompt admission.

    Faults due at a tick fire first, before completions (see
    ``_apply_faults``), so migrations and recoveries see the lane state the
    fault struck.
    """

    def __init__(self, cfg: PagedKVConfig, n_lanes: int = 16,
                 max_seq: int = 256, policy="seq-skew",
                 n_kv_layers: int = 1, reserve_scratch: bool = True,
                 fault_plan: FaultPlan | None = None,
                 prefill_chunk_pages: int | None = None,
                 watchdog=None,
                 timer: Callable[[], float] = time.perf_counter):
        self.cfg = cfg
        self.n_lanes = n_lanes
        self.max_seq = max_seq
        self.max_pages = -(-max_seq // cfg.page_len)
        self.n_kv_layers = n_kv_layers
        if prefill_chunk_pages is not None and prefill_chunk_pages < 1:
            raise ValueError(f"prefill_chunk_pages must be >= 1, "
                             f"got {prefill_chunk_pages}")
        #: chunked prefill (None = whole-prompt admission); construction
        #: config, not serialized state: restore with the same value
        self.prefill_chunk_pages = prefill_chunk_pages
        self._prefill_next: dict[int, int] = {}   # lane -> next page index
        self.policy_name = policy if isinstance(policy, str) else "custom"
        #: one pool page is reserved as the sink idle lanes' scatters
        #: target in live runs (predicated off in every trace); reserving
        #: it in simulation too keeps both allocators identical
        self.scratch_page = (int(cfg.layout.logical_row(
            np.asarray(cfg.n_banks - 1), np.asarray(cfg.pages_per_bank - 1)))
            if reserve_scratch else None)
        self.pool = PagePool(
            cfg, policy=policy,
            reserve=() if self.scratch_page is None else (self.scratch_page,))
        self.now = 0
        self.queue: list[Request] = []
        self.lane_rid = np.full(n_lanes, -1, np.int64)
        self.lane_pos = np.zeros(n_lanes, np.int32)
        self.lane_steps_left = np.zeros(n_lanes, np.int32)
        self.page_table = np.full((n_lanes, self.max_pages), -1, np.int32)
        self._by_rid: dict[int, Request] = {}
        self._cancelled: set[int] = set()
        self._busy_lane_ticks = 0
        self._decode_ticks = 0
        self._n_prefill_chunks = 0
        #: the seeded fault timeline: construction config like
        #: ``prefill_chunk_pages`` (restore with the same plan; the cursor
        #: is serialized state)
        self._fault_plan = fault_plan
        self._fault_cursor = 0
        self._degraded = False
        self._dead_banks: list[int] = []
        self._n_migrated_pages = 0
        self._n_recoveries = 0
        self._n_transients = 0
        self._n_preempts = 0
        #: optional straggler detection (``runtime.StepWatchdog``): each
        #: decode step is timed with ``timer``; straggler ticks are
        #: recorded (after any callback of the caller's) for ``stats()``
        self._watchdog = watchdog
        self._timer = timer
        self._straggler_ticks: list[int] = []
        if watchdog is not None:
            user_cb = watchdog.on_straggler

            def _record(step, seconds, med, _user=user_cb):
                self._straggler_ticks.append(int(step))
                if _user is not None:
                    _user(step, seconds, med)

            watchdog.on_straggler = _record

    # -- submission / cancellation -----------------------------------------

    def submit(self, requests: Iterable[Request]) -> None:
        for r in requests:
            if r.total_len > self.max_seq:
                raise ValueError(
                    f"request {r.rid}: prompt {r.prompt_len} + new "
                    f"{r.max_new_tokens} exceeds max_seq {self.max_seq}")
            if r.rid in self._by_rid:
                raise ValueError(f"duplicate request id {r.rid}")
            self._by_rid[r.rid] = r
            self.queue.append(r)
        self.queue.sort(key=lambda r: (r.arrival, r.rid))

    def cancel(self, rid: int) -> None:
        """Evict a request mid-flight (or drop it from the queue).  A
        resident sequence leaves at the next tick's completion phase: its
        pages return to the pool and the lane is re-admittable at once."""
        if any(r.rid == rid for r in self.queue):
            self.queue = [r for r in self.queue if r.rid != rid]
            self._by_rid.pop(rid)
            return
        if rid not in self._by_rid:
            raise KeyError(f"unknown request id {rid}")
        self._cancelled.add(rid)

    # -- fault injection and recovery ---------------------------------------

    @property
    def dead_banks(self) -> tuple:
        """Banks lost so far, ascending: ``arch.degrade(sched.dead_banks)``
        prices the current layout."""
        return tuple(sorted(self._dead_banks))

    def _apply_faults(self, ev: TickEvent) -> None:
        if self._fault_plan is None:
            return
        events, self._fault_cursor = self._fault_plan.due(
            self.now, self._fault_cursor)
        for f in events:
            if f.kind == "bank_offline":
                self._bank_offline(f, ev)
            elif f.kind == "page_corrupt":
                self._page_corrupt(f, ev)
            elif f.kind == "decode_transient":
                ev.transients += f.failures
                self._n_transients += f.failures
            elif f.kind == "preempt":
                ev.preempt = True
                self._n_preempts += 1

    def _bank_offline(self, f: FaultEvent, ev: TickEvent) -> None:
        """Lose a bank: evict its live pages from the pool, give each a new
        page on a surviving bank (same in-sequence index, so the
        preferred-bank policy places it), patch the page tables and emit
        the evacuation burst as a ``fault_migrate`` trace block.  The data
        is kept: the live engine copies every page (contrast
        ``page_corrupt``)."""
        if self.scratch_page is not None:
            sb = int(np.asarray(
                self.cfg.layout.bank_slot(np.asarray(self.scratch_page))[0]))
            if f.bank == sb:
                raise ValueError(
                    f"bank {f.bank} hosts the reserved scratch page; the "
                    f"fault plan may not take it offline (synthesize() "
                    f"never picks it)")
        live = self.pool.offline_bank(f.bank)
        self._degraded = True
        if f.bank not in self._dead_banks:
            self._dead_banks.append(f.bank)
        liveset = set(live)
        old_ids: list[int] = []
        new_ids: list[int] = []
        lanes: list[int] = []
        slots: list[int] = []
        for lane in range(self.n_lanes):          # deterministic order
            row = self.page_table[lane]
            for k in np.flatnonzero(row >= 0):
                pid = int(row[k])
                if pid in liveset:
                    new = self.pool.alloc(int(k), int(self.lane_rid[lane]))
                    row[k] = new
                    old_ids.append(pid)
                    new_ids.append(new)
                    lanes.append(lane)
                    slots.append(int(k))
        if len(old_ids) != len(live):
            raise RuntimeError(
                f"bank {f.bank}: {len(live)} live pages but only "
                f"{len(old_ids)} found in lane page tables")
        ev.migrations.append({"tick": self.now, "bank": f.bank,
                              "old_ids": old_ids, "new_ids": new_ids,
                              "lanes": lanes, "slots": slots})
        self._n_migrated_pages += len(old_ids)
        if old_ids:
            ev.traces.append(fault_migrate_trace(
                self.cfg, old_ids, new_ids, self.n_kv_layers,
                bank=f.bank, tick=self.now))

    def _page_corrupt(self, f: FaultEvent, ev: TickEvent) -> None:
        """An uncorrectable page error (ECC parity): the page's data is
        lost.  Recovery rebuilds it: re-prefill the request's prompt pages,
        then replay its ``lane_pos - prompt_len`` completed decode steps one
        lane at a time (positions ``plen + j``), which rewrites every
        decode-written slot in order.  The replay's trace blocks are
        emitted here, so simulation replays the same burst; the live engine
        also re-runs the model and holds the replayed tokens to the
        originals.  A request that is not resident (completed, still
        queued) or is still mid-chunked-prefill (its remaining chunks
        rewrite the prompt pages anyway) makes the event a recorded
        no-op."""
        lanes = np.flatnonzero(self.lane_rid == f.rid)
        if lanes.size == 0:
            ev.recoveries.append({"tick": self.now, "rid": f.rid,
                                  "lane": -1, "skipped": True})
            return
        lane = int(lanes[0])
        if lane in self._prefill_next:
            ev.recoveries.append({"tick": self.now, "rid": f.rid,
                                  "lane": lane, "skipped": True})
            return
        r = self._by_rid[f.rid]
        row = self.page_table[lane]
        mapped = row[row >= 0]
        pid = int(mapped[f.page_idx % mapped.shape[0]])
        plen = r.prompt_len
        n_pref = -(-plen // self.cfg.page_len)
        prompt_ids = row[:n_pref].copy()
        steps = int(self.lane_pos[lane]) - plen
        t = admission_prefill_trace(self.cfg, prompt_ids, self.n_kv_layers,
                                    rid=f.rid)
        t.meta["what"] = "fault_reprefill"
        t.meta["tick"] = self.now
        ev.traces.append(t)
        for j in range(steps):
            pos = self.lane_pos.copy()
            pos[lane] = plen + j
            act = np.zeros(self.n_lanes, bool)
            act[lane] = True
            tr = scheduler_step_trace(self.cfg, self.page_table.copy(), pos,
                                      act, self.n_kv_layers, tick=self.now,
                                      degraded=self._degraded)
            tr.meta["replay"] = True
            ev.traces.append(tr)
        ev.recoveries.append({"tick": self.now, "rid": f.rid, "lane": lane,
                              "request": r, "pid": pid, "plen": plen,
                              "steps": steps, "prompt_ids": prompt_ids,
                              "page_table": self.page_table.copy(),
                              "pos": self.lane_pos.copy(), "skipped": False})
        self._n_recoveries += 1

    # -- lifecycle ----------------------------------------------------------

    def done(self) -> bool:
        return not self.queue and bool((self.lane_rid < 0).all())

    def _complete(self, ev: TickEvent) -> None:
        for lane in range(self.n_lanes):
            rid = int(self.lane_rid[lane])
            if rid < 0:
                continue
            cancelled = rid in self._cancelled
            if lane in self._prefill_next and not cancelled:
                continue                      # mid-prefill: not done, not idle
            if self.lane_steps_left[lane] > 0 and not cancelled:
                continue
            self._prefill_next.pop(lane, None)
            row = self.page_table[lane]
            self.pool.release(int(p) for p in row[row >= 0])
            row[:] = -1
            self.lane_rid[lane] = -1
            self.lane_pos[lane] = 0
            self.lane_steps_left[lane] = 0
            self._cancelled.discard(rid)
            ev.completed.append(Completion(self._by_rid[rid], lane,
                                           self.now, cancelled=cancelled))

    def _admit(self, ev: TickEvent) -> None:
        for lane in range(self.n_lanes):
            if self.lane_rid[lane] >= 0:
                continue
            if not self.queue or self.queue[0].arrival > self.now:
                return
            r = self.queue.pop(0)
            n_pref = -(-r.prompt_len // self.cfg.page_len)
            if self.prefill_chunk_pages is None:
                ids = np.array([self.pool.alloc(k, r.rid)
                                for k in range(n_pref)], np.int32)
                self.page_table[lane, :n_pref] = ids
                self.lane_rid[lane] = r.rid
                self.lane_pos[lane] = r.prompt_len
                # first token comes from prefill; m-1 ragged decode steps
                self.lane_steps_left[lane] = max(0, r.max_new_tokens - 1)
                ev.admitted.append(Admission(r, lane, ids))
                ev.traces.append(admission_prefill_trace(
                    self.cfg, ids, self.n_kv_layers, rid=r.rid))
            else:
                # chunked admission: register the lane prefilling (position
                # and budget arrive when the last chunk lands) and ingest
                # chunk 0 this tick
                self.lane_rid[lane] = r.rid
                self.lane_pos[lane] = 0
                self.lane_steps_left[lane] = 0
                self._prefill_next[lane] = 0
                ids = self._ingest_chunk(lane, r, ev)
                ev.admitted.append(Admission(r, lane, ids))

    def _ingest_chunk(self, lane: int, r: Request, ev: TickEvent
                      ) -> np.ndarray:
        """Allocate and ingest one prefill chunk for a prefilling lane:
        the next ``prefill_chunk_pages`` prompt pages (fewer on the last
        chunk), emitted as one page-scatter trace block and one
        ``ev.prefill_chunks`` record.  The final chunk makes the lane
        decodable (position = prompt length, remaining budget set), and it
        joins this tick's decode step."""
        n_pref = -(-r.prompt_len // self.cfg.page_len)
        start = self._prefill_next[lane]
        end = min(start + self.prefill_chunk_pages, n_pref)
        ids = np.array([self.pool.alloc(k, r.rid)
                        for k in range(start, end)], np.int32)
        self.page_table[lane, start:end] = ids
        done = end >= n_pref
        t = admission_prefill_trace(self.cfg, ids, self.n_kv_layers,
                                    rid=r.rid)
        t.meta.update({"what": "sched_prefill_chunk", "page_start": start,
                       "done": done, "tick": self.now})
        ev.traces.append(t)
        ev.prefill_chunks.append({"rid": r.rid, "lane": lane,
                                  "page_ids": ids, "page_start": start,
                                  "done": done})
        self._n_prefill_chunks += 1
        if done:
            del self._prefill_next[lane]
            self.lane_pos[lane] = r.prompt_len
            # first token comes from prefill; m-1 ragged decode steps
            self.lane_steps_left[lane] = max(0, r.max_new_tokens - 1)
        else:
            self._prefill_next[lane] = end
        return ids

    def _prefill_continue(self, ev: TickEvent) -> None:
        """Advance every lane that is mid-prefill by one chunk (runs before
        admission, so a lane admitted this tick only ingests its chunk
        0)."""
        for lane in sorted(self._prefill_next):
            self._ingest_chunk(lane, self._by_rid[int(self.lane_rid[lane])],
                               ev)

    def _decode(self, ev: TickEvent) -> None:
        active = (self.lane_rid >= 0) & (self.lane_steps_left > 0)
        if not active.any():
            return
        for lane in np.flatnonzero(active):
            pos = int(self.lane_pos[lane])
            if pos % self.cfg.page_len == 0:
                k = pos // self.cfg.page_len
                self.page_table[lane, k] = self.pool.alloc(
                    k, int(self.lane_rid[lane]))
        ev.decoded = True
        ev.page_table = self.page_table.copy()
        ev.pos = self.lane_pos.copy()
        ev.active = active
        ev.traces.append(scheduler_step_trace(
            self.cfg, ev.page_table, ev.pos, active, self.n_kv_layers,
            tick=self.now, degraded=self._degraded))
        self.lane_pos[active] += 1
        self.lane_steps_left[active] -= 1
        self._decode_ticks += 1

    def tick(self) -> TickEvent:
        """Run one scheduler tick (see the class docstring for the phases;
        faults due at this tick fire first)."""
        ev = TickEvent(tick=self.now)
        self._apply_faults(ev)
        self._complete(ev)
        self._prefill_continue(ev)
        self._admit(ev)
        t0 = self._timer()
        self._decode(ev)
        if ev.decoded and self._watchdog is not None:
            self._watchdog.observe(self.now, self._timer() - t0)
        self._busy_lane_ticks += int((self.lane_rid >= 0).sum())
        self.now += 1
        if (not ev.decoded and not ev.admitted and not ev.completed
                and self.queue and (self.lane_rid < 0).all()):
            self.now = max(self.now, self.queue[0].arrival)  # fast-forward
        return ev

    def run(self, requests: Iterable[Request] | None = None
            ) -> Iterator[TickEvent]:
        """Submit ``requests`` (if given) and tick until every request has
        completed, yielding each tick's event."""
        if requests is not None:
            self.submit(requests)
        while not self.done():
            yield self.tick()

    # -- introspection -------------------------------------------------------

    def stats(self) -> dict:
        """Run statistics: makespan, decode-step count, mean lane
        occupancy, the pool's ``bank_load_stats`` (occupancy skew, what the
        preferred-bank policy is judged on), the fault counters and, with a
        watchdog, its stragglers."""
        from repro_torch.serving.kvcache import bank_load_stats
        ticks = max(1, self.now)
        out = {
            "ticks": self.now,
            "decode_ticks": self._decode_ticks,
            "prefill_chunks": self._n_prefill_chunks,
            "lane_occupancy": self._busy_lane_ticks / (ticks * self.n_lanes),
            **{f"bank_{k}": float(v)
               for k, v in bank_load_stats(self.pool).items()},
            "faults": {
                "migrated_pages": self._n_migrated_pages,
                "recoveries": self._n_recoveries,
                "transients": self._n_transients,
                "preempts": self._n_preempts,
                "dead_banks": list(self.dead_banks),
                "degraded": self._degraded,
            },
        }
        if self._watchdog is not None:
            out["stragglers"] = self._watchdog.stragglers
            out["straggler_ticks"] = list(self._straggler_ticks)
        return out

    # -- serialization ---------------------------------------------------------

    def state_dict(self) -> dict:
        """The scheduler's control-plane state as a JSON-serializable dict
        (lane arrays, queue, pool bitmap, fault cursor and counters).  The
        fault plan and the watchdog are not serialized: construct with the
        same plan and ``fault_cursor`` resumes it."""
        def req(r: Request) -> dict:
            return {"rid": r.rid, "arrival": r.arrival,
                    "prompt_len": r.prompt_len,
                    "max_new_tokens": r.max_new_tokens,
                    "tokens": (None if r.tokens is None
                               else np.asarray(r.tokens).tolist())}
        return {
            "now": int(self.now),
            "lane_rid": self.lane_rid.tolist(),
            "lane_pos": self.lane_pos.tolist(),
            "lane_steps_left": self.lane_steps_left.tolist(),
            "page_table": self.page_table.tolist(),
            "queue": [r.rid for r in self.queue],
            "requests": [req(r) for r in self._by_rid.values()],
            "cancelled": sorted(self._cancelled),
            "busy_lane_ticks": int(self._busy_lane_ticks),
            "decode_ticks": int(self._decode_ticks),
            "prefill_chunks": int(self._n_prefill_chunks),
            "prefill_next": {str(lane): int(nxt)
                             for lane, nxt in sorted(
                                 self._prefill_next.items())},
            "fault_cursor": int(self._fault_cursor),
            "degraded": bool(self._degraded),
            "dead_banks": [int(b) for b in self._dead_banks],
            "migrated_pages": int(self._n_migrated_pages),
            "recoveries": int(self._n_recoveries),
            "transients": int(self._n_transients),
            "preempts": int(self._n_preempts),
            "straggler_ticks": list(self._straggler_ticks),
            "pool": self.pool.state_dict(),
        }

    def load_state(self, state: dict) -> None:
        """Restore ``state_dict`` output into a scheduler built with the
        same config (pool layout, lane count, max_seq, KV layers)."""
        lane_rid = np.asarray(state["lane_rid"], np.int64)
        if lane_rid.shape[0] != self.n_lanes:
            raise ValueError(
                f"the state has {lane_rid.shape[0]} lanes, this scheduler "
                f"has {self.n_lanes}")
        self.now = int(state["now"])
        self.lane_rid = lane_rid
        self.lane_pos = np.asarray(state["lane_pos"], np.int32)
        self.lane_steps_left = np.asarray(state["lane_steps_left"], np.int32)
        self.page_table = np.asarray(state["page_table"], np.int32)
        by: dict[int, Request] = {}
        for d in state["requests"]:
            tokens = (None if d["tokens"] is None
                      else np.asarray(d["tokens"], np.int32))
            by[int(d["rid"])] = Request(
                rid=int(d["rid"]), arrival=int(d["arrival"]),
                prompt_len=int(d["prompt_len"]),
                max_new_tokens=int(d["max_new_tokens"]), tokens=tokens)
        self._by_rid = by
        self.queue = [by[int(r)] for r in state["queue"]]
        self._cancelled = {int(r) for r in state["cancelled"]}
        self._busy_lane_ticks = int(state["busy_lane_ticks"])
        self._decode_ticks = int(state["decode_ticks"])
        self._n_prefill_chunks = int(state.get("prefill_chunks", 0))
        self._prefill_next = {int(lane): int(nxt) for lane, nxt
                              in state.get("prefill_next", {}).items()}
        self._fault_cursor = int(state["fault_cursor"])
        self._degraded = bool(state["degraded"])
        self._dead_banks = [int(b) for b in state["dead_banks"]]
        self._n_migrated_pages = int(state["migrated_pages"])
        self._n_recoveries = int(state["recoveries"])
        self._n_transients = int(state["transients"])
        self._n_preempts = int(state["preempts"])
        self._straggler_ticks = [int(t) for t in state["straggler_ticks"]]
        self.pool.load_state(state["pool"])


# --------------------------------------------------------------------------
# the day as a Trace
# --------------------------------------------------------------------------

def scheduler_pool_config(arch, n_lanes: int, max_seq: int,
                          page_len: int) -> PagedKVConfig:
    """The trace-lowering pool for a scheduler run under ``arch``: banking
    from the arch's layout (non-banked architectures price the canonical
    16-bank LSB pool, like ``simulate_serving_stream``), 1-word page lines
    (the trace is page-id granular), the pool sized as the live engine's
    (``pool_pages`` on the same budget), so simulated and live allocators
    make identical decisions."""
    from repro_torch.core import arch as _arch
    a = _arch.resolve(arch)
    if a.layout is not None:
        return PagedKVConfig.from_arch(
            a, n_pages=pool_pages(a.layout.n_banks, n_lanes, max_seq,
                                  page_len),
            page_len=page_len, kv_heads=1, head_dim=1)
    return PagedKVConfig(
        n_pages=pool_pages(16, n_lanes, max_seq, page_len),
        page_len=page_len, n_banks=16, mapping="lsb", kv_heads=1,
        head_dim=1, map_shift=1)


def simulate_scheduler_stream(arch, requests: list[Request],
                              n_lanes: int = 16, max_seq: int = 256,
                              page_len: int = 8, n_kv_layers: int = 1,
                              policy="seq-skew",
                              fault_plan: FaultPlan | None = None,
                              prefill_chunk_pages: int | None = None):
    """A serving day's KV traffic as a lazy, re-iterable ``TraceStream``:
    one source block per prefill ingest / ragged decode step, produced on
    demand by replaying the scheduler (each iteration runs a fresh
    ``Scheduler``, so thousand-sequence days cost in O(block) host
    memory).  The traffic depends on the architecture: the pool places
    pages under the arch's bank map, skewed by ``policy``.

    ``fault_plan`` replays a seeded fault timeline inside every
    iteration's fresh scheduler (the plan is immutable, the cursor lives in
    the scheduler), so a faulted day's stream is as re-iterable as a
    healthy one, and bit-equal to a live ``ServeEngine.run_scheduler`` run
    under the same plan."""
    from repro_torch.core import arch as _arch
    from repro_torch.core.trace import TraceStream
    cfg = scheduler_pool_config(arch, n_lanes, max_seq, page_len)
    reqs = list(requests)

    def blocks():
        sched = Scheduler(cfg, n_lanes=n_lanes, max_seq=max_seq,
                          policy=policy, n_kv_layers=n_kv_layers,
                          fault_plan=fault_plan,
                          prefill_chunk_pages=prefill_chunk_pages)
        for ev in sched.run(reqs):
            yield from ev.traces

    meta = {
        "what": "scheduler", "arch": _arch.resolve(arch).name,
        "n_requests": len(reqs), "n_lanes": n_lanes, "max_seq": max_seq,
        "page_len": page_len, "n_kv_layers": n_kv_layers,
        "policy": policy if isinstance(policy, str) else "custom",
        "n_tokens": total_new_tokens(reqs)}
    if prefill_chunk_pages is not None:
        meta["prefill_chunk_pages"] = prefill_chunk_pages
    if fault_plan is not None:
        meta["faults"] = fault_plan.counts()
    return TraceStream(blocks, meta=meta)
