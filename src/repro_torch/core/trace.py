"""First-class address traces — the artifact the paper's cost model consumes
(port of ``repro.core.trace``; host-side numpy, as in the reference: blocks
move to the device only at the cost-engine boundary).

An ``AddressTrace`` is the exact request stream a SIMT shared-memory
subsystem sees, detached from whatever produced it (a kernel's index
stream, an ISA program, a synthetic sweep).  One trace can be costed under
every ``MemoryArchitecture`` via ``arch.cost(trace)`` without re-executing
anything — the same separation the paper uses to run 51 benchmarks over 9
memories.

Trace schema
============

A trace is a flat sequence of memory *operations*.  One operation is one
clock's worth of ``LANES`` (= 16) lane requests; operations group into
*instructions* (a load/store macro-op issued by one program instruction —
multi-word I/Q accesses are several operations under a single instruction,
which is what makes per-instruction controller overhead accounting exact).

  ``addrs``  (n_ops, LANES) int32   word address requested by each lane
  ``kinds``  (n_ops,)       int8    ``KIND_LOAD`` / ``KIND_STORE`` /
                                    ``KIND_TW`` (twiddle loads are reported
                                    separately, Table III's TW rows)
  ``instr``  (n_ops,)       int32   instruction id per op (non-decreasing);
                                    each distinct id pays the architecture's
                                    per-instruction pipeline overhead once
  ``mask``   (n_ops, LANES) bool    active lanes (None = all active);
                                    predicated lanes issue no request

plus the compute-side metadata needed to report full Table II/III rows:

  ``compute_cycles``  int    cycles spent in ALU bundles
  ``op_counts``       dict   Table "Common Ops" cycle buckets
                             (``fp`` / ``int`` / ``imm`` / ``other``)

Construction: ``AddressTrace.from_stream`` (one instruction from a flat
request stream), ``AddressTrace.from_ops`` (pre-shaped operation matrices),
``AddressTrace.from_program`` (an ISA macro-op program), or incrementally
through ``TraceBuilder``.  Traces compose with ``+`` and slice with
``[start:stop]`` over operations.

The Trace protocol
==================

Every costed object — dense or lazy — answers one iteration protocol::

    trace.blocks(block_ops=None) -> Iterator[AddressTrace]
    trace.meta                   -> dict
    trace.n_ops                  -> int | None   (None when unknowable lazily)

``blocks`` yields ``AddressTrace`` blocks whose instruction ids are
*globally consistent and non-decreasing* across the whole iteration: an
instruction cut by a block boundary keeps one id on both sides (so its
controller overhead is charged exactly once), and per-block
``compute_cycles`` / ``op_counts`` sum to the trace totals.  A dense
``AddressTrace`` is the one-block special case; ``TraceStream`` is the lazy
many-block case; ``as_trace`` coerces raw block iterables.  The batched cost
engine (``repro_torch.core.cost_engine.cost_many``) consumes nothing else — dense,
chunked, and streamed costing are bit-equal by construction.

Stream *sources* (what a ``TraceStream`` iterates) are ordinary traces with
LOCAL instruction ids; the stream renumbers them onto the global axis as it
yields.  A source block carrying ``meta["instr_carry"] = True`` declares its
first instruction to be the continuation of the previous block's last one
(``iter_op_chunks`` and ``AddressTrace.iter_blocks`` mark continuation
chunks this way), which is how a single huge instruction — e.g. a
million-index gather — streams in O(block) memory without ever splitting
into several charged instructions.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Protocol

import numpy as np

from repro_torch.core.memsim import LANES

__all__ = ["AddressTrace", "TraceBuilder", "TraceStream", "Trace",
           "TraceContractError", "as_trace", "as_ops", "iter_op_chunks",
           "KIND_LOAD", "KIND_STORE", "KIND_TW", "LANES"]

KIND_LOAD, KIND_STORE, KIND_TW = 0, 1, 2


class TraceContractError(ValueError):
    """A trace violated the Trace protocol contract (non-decreasing
    instruction ids, legal ``instr_carry`` chains, shape/kind/address
    consistency).  Raised at coercion/iteration time by ``as_trace`` /
    ``TraceStream.blocks``."""


def _check_instr_monotonic(t: "AddressTrace", where: str) -> None:
    """The cheap streaming contract check: a block's instruction ids must be
    non-decreasing, or every distinct-instruction count downstream (the cost
    engine's per-kind overhead accounting, ``_renumbered``'s dense
    renumbering) silently goes wrong."""
    if _decreases(t.instr):
        raise TraceContractError(
            f"{where}: instruction ids must be non-decreasing within a "
            f"block (got a decrease; ids start {t.instr[:8].tolist()}...) — "
            f"renumber the block or build it through TraceBuilder/concat")

_KIND_NAMES = {"load": KIND_LOAD, "store": KIND_STORE, "tw": KIND_TW,
               "D": KIND_LOAD, "S": KIND_STORE, "TW": KIND_TW}


def _decreases(ids: np.ndarray) -> bool:
    """True when an id array breaks the schema's non-decreasing order.  Ids
    in order are counted and renumbered by runs, without ``np.unique``'s
    sort; ids out of order go through ``np.unique``."""
    return ids.size > 1 and bool((ids[1:] < ids[:-1]).any())


def _id_runs(ids: np.ndarray) -> tuple:
    """(count of distinct ids, first id, last id) of a non-empty id array,
    first and last in sorted order."""
    if _decreases(ids):
        ids = np.unique(ids)
        return ids.size, int(ids[0]), int(ids[-1])
    return (1 + int(np.count_nonzero(ids[1:] != ids[:-1])),
            int(ids[0]), int(ids[-1]))


def _dense_ids(instr: np.ndarray) -> tuple:
    """Order-preserving dense renumbering of instruction ids onto 0, 1, ...
    and the count of distinct ids (see ``_decreases``)."""
    if not instr.size:
        return instr.astype(np.int32), 0
    if _decreases(instr):
        _, dense = np.unique(instr, return_inverse=True)
        dense = dense.astype(np.int32).reshape(-1)
        return dense, int(dense.max()) + 1
    change = np.empty(instr.size, np.int32)
    change[0] = 0
    np.not_equal(instr[1:], instr[:-1], out=change[1:])
    dense = np.cumsum(change, dtype=np.int32)
    return dense, int(dense[-1]) + 1


def _kind_code(kind) -> int:
    if isinstance(kind, str):
        try:
            return _KIND_NAMES[kind]
        except KeyError:
            raise ValueError(f"unknown op kind {kind!r}; use 'load', "
                             f"'store' or 'tw'") from None
    if kind in (KIND_LOAD, KIND_STORE, KIND_TW):
        return int(kind)
    raise ValueError(f"unknown op kind {kind!r}")


def as_ops(addrs) -> np.ndarray:
    """(T,), (k, T) or (ops, LANES) request stream -> (ops, LANES) matrix.

    Multi-word instructions issue word 0 for all threads, then word 1, ... —
    each word is its own run of 16-lane operations (C-order reshape).  A
    ragged tail replicates the final address into idle lanes (idle lanes
    re-request the same bank in hardware; negligible for aligned sizes).
    """
    a = np.asarray(addrs, np.int32).reshape(-1)
    pad = (-a.shape[0]) % LANES
    if pad:
        a = np.concatenate([a, np.repeat(a[-1], pad)])
    return a.reshape(-1, LANES)


class Trace(Protocol):
    """Structural protocol every costed trace object answers (see the module
    docstring): ``blocks(block_ops)`` iteration with globally consistent
    instruction ids, a ``meta`` dict, and ``n_ops`` (None when lazy).
    ``AddressTrace`` and ``TraceStream`` are the two implementations;
    ``as_trace`` coerces raw block iterables."""

    meta: dict

    def blocks(self, block_ops: int | None = None
               ) -> Iterator["AddressTrace"]: ...


def as_trace(obj) -> "AddressTrace | TraceStream":
    """Coerce anything trace-like to a ``Trace``: ``AddressTrace`` and
    ``TraceStream`` pass through (as does any object with a ``blocks``
    method); a zero-arg callable or an iterable of ``AddressTrace`` blocks
    is wrapped as a ``TraceStream`` (independent-source semantics).

    Coercion rejects dense traces whose instruction ids *decrease* (a
    ``TraceContractError``): such ids silently corrupt every
    distinct-instruction count downstream, so they fail fast here instead.
    Stream sources get the same check lazily, block-by-block, as
    ``TraceStream.blocks`` draws them."""
    if isinstance(obj, AddressTrace):
        _check_instr_monotonic(obj, "as_trace")
        return obj
    if isinstance(obj, TraceStream):
        return obj
    if callable(getattr(obj, "blocks", None)):
        return obj
    if callable(obj) or hasattr(obj, "__iter__"):
        return TraceStream(obj)
    raise TypeError(f"cannot interpret {obj!r} as a Trace (expected an "
                    f"AddressTrace, a TraceStream, or an iterable / "
                    f"callable of AddressTrace blocks)")


@dataclass(frozen=True, eq=False)
class AddressTrace:
    """A costed-object request stream (see module docstring for the schema)."""

    addrs: np.ndarray                 # (n_ops, LANES) int32
    kinds: np.ndarray                 # (n_ops,) int8
    instr: np.ndarray                 # (n_ops,) int32
    mask: np.ndarray | None = None    # (n_ops, LANES) bool, None = all active
    compute_cycles: int = 0
    op_counts: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        a = np.asarray(self.addrs, np.int32).reshape(-1, LANES)
        object.__setattr__(self, "addrs", a)
        object.__setattr__(self, "kinds",
                           np.asarray(self.kinds, np.int8).reshape(-1))
        object.__setattr__(self, "instr",
                           np.asarray(self.instr, np.int32).reshape(-1))
        if self.mask is not None:
            object.__setattr__(
                self, "mask", np.asarray(self.mask, bool).reshape(-1, LANES))
        n = a.shape[0]
        if self.kinds.shape[0] != n or self.instr.shape[0] != n or (
                self.mask is not None and self.mask.shape[0] != n):
            raise ValueError("addrs/kinds/instr/mask op counts disagree")

    # -- construction ------------------------------------------------------

    @classmethod
    def empty(cls) -> "AddressTrace":
        return cls(np.zeros((0, LANES), np.int32), np.zeros(0, np.int8),
                   np.zeros(0, np.int32))

    @classmethod
    def from_ops(cls, addrs, kind="load", mask=None,
                 meta: dict | None = None) -> "AddressTrace":
        """One instruction from a pre-shaped / reshapeable op stream."""
        ops = as_ops(addrs)
        code = _kind_code(kind)
        if mask is not None:
            # ragged tails pad addresses by replicating the last request
            # (as_ops); the padded idle lanes are inactive, not duplicates
            mask = np.asarray(mask, bool).reshape(-1)
            pad = ops.size - mask.shape[0]
            if pad:
                mask = np.concatenate([mask, np.zeros(pad, bool)])
            mask = mask.reshape(ops.shape)
        return cls(ops, np.full(ops.shape[0], code, np.int8),
                   np.zeros(ops.shape[0], np.int32), mask,
                   meta=dict(meta or {}))

    #: alias — a flat per-thread request stream is just the (T,) case
    from_stream = from_ops

    @classmethod
    def from_program(cls, program) -> "AddressTrace":
        """The exact trace an ISA macro-op ``Program`` emits (see isa.vm —
        the VM costs this very object, so kernel- and VM-derived cycles are
        cross-validated by construction)."""
        from repro_torch.isa.assembler import Compute, MemLoad, MemStore
        b = TraceBuilder(n_threads=program.n_threads)
        for ins in program.instrs:
            if isinstance(ins, MemLoad):
                b.load(ins.addrs, space=ins.space)
            elif isinstance(ins, MemStore):
                b.store(ins.addrs)
            elif isinstance(ins, Compute):
                b.compute(ins.counts, scalar=ins.scalar)
            else:  # pragma: no cover
                raise TypeError(f"unknown instruction {ins!r}")
        return b.build(meta={"program": program.name, **program.meta})

    @classmethod
    def concat(cls, *traces: "AddressTrace") -> "AddressTrace":
        """Compose traces back-to-back.  Each source trace's instruction ids
        are renumbered densely (sliced / kind-filtered traces may carry
        sparse ids) and then offset, so every source instruction pays its
        overhead exactly once; compute cycles and op-count buckets sum over
        all operands, including memory-less (compute-only) traces."""
        counts: dict = {}
        for t in traces:
            for k, v in t.op_counts.items():
                counts[k] = counts.get(k, 0) + v
        compute = sum(t.compute_cycles for t in traces)
        nonempty = [t for t in traces if t.n_ops]
        if not nonempty:
            return cls.empty().with_compute(compute, counts)
        instrs, off = [], 0
        any_mask = any(t.mask is not None for t in nonempty)
        masks = []
        for t in nonempty:
            dense, n = _dense_ids(t.instr)
            instrs.append(dense + off)
            off += n
            if any_mask:
                masks.append(np.ones_like(t.addrs, bool) if t.mask is None
                             else t.mask)
        return cls(np.concatenate([t.addrs for t in nonempty]),
                   np.concatenate([t.kinds for t in nonempty]),
                   np.concatenate(instrs),
                   np.concatenate(masks) if any_mask else None,
                   compute_cycles=compute,
                   op_counts=counts)

    def __add__(self, other: "AddressTrace") -> "AddressTrace":
        return AddressTrace.concat(self, other)

    # -- views / slicing ---------------------------------------------------

    @property
    def n_ops(self) -> int:
        return self.addrs.shape[0]

    @property
    def n_instructions(self) -> int:
        return _dense_ids(self.instr)[1]

    @property
    def n_words(self) -> int:
        """Smallest word-memory size the trace addresses fit in."""
        return int(self.addrs.max()) + 1 if self.n_ops else 0

    def _select(self, sel) -> "AddressTrace":
        return AddressTrace(self.addrs[sel], self.kinds[sel], self.instr[sel],
                            None if self.mask is None else self.mask[sel],
                            meta=dict(self.meta))

    def of_kind(self, kind) -> "AddressTrace":
        """Memory-only sub-trace of one op kind (compute metadata dropped)."""
        return self._select(self.kinds == _kind_code(kind))

    def loads(self) -> "AddressTrace":
        return self.of_kind(KIND_LOAD)

    def stores(self) -> "AddressTrace":
        return self.of_kind(KIND_STORE)

    def tw_loads(self) -> "AddressTrace":
        return self.of_kind(KIND_TW)

    def __getitem__(self, item) -> "AddressTrace":
        if not isinstance(item, slice):
            raise TypeError("AddressTrace slices over op ranges only")
        return self._select(item)

    # -- the Trace protocol ------------------------------------------------

    def blocks(self, block_ops: int | None = None):
        """The Trace protocol: this trace as at-most-``block_ops``-op blocks
        sharing the trace's (global) instruction ids — the dense trace is
        the one-block special case.  Compute metadata rides on the first
        block, so per-block sums reproduce the trace totals; costing the
        blocks is bit-equal to costing the dense trace at any block size."""
        if block_ops is not None and block_ops <= 0:
            raise ValueError(f"block_ops must be positive, got {block_ops}")
        if block_ops is None or self.n_ops <= block_ops:
            yield self
            return
        first = True
        for blk in self.iter_blocks(block_ops):
            if first and (self.compute_cycles or self.op_counts):
                blk = blk.with_compute(self.compute_cycles, self.op_counts)
            first = False
            yield blk

    def iter_blocks(self, block_ops: int):
        """Iterate the trace as ``block_ops``-sized op blocks (the last one
        ragged).  Blocks are views keeping the *global* instruction ids, so
        an instruction cut by a block boundary stays one instruction; a
        continuation block whose first instruction is the cut one is
        additionally ``instr_carry``-marked, making the views valid stream
        sources.  Views carry no compute metadata — iterate
        ``blocks(block_ops)`` for the full protocol (compute included)."""
        if block_ops <= 0:
            raise ValueError(f"block_ops must be positive, got {block_ops}")
        prev_last = None
        for start in range(0, self.n_ops, block_ops):
            blk = self._select(slice(start, start + block_ops))
            if prev_last is not None and blk.instr[0] == prev_last:
                blk.meta["instr_carry"] = True
            prev_last = int(blk.instr[-1])
            yield blk

    def _renumbered(self, base: int) -> tuple:
        """(this trace with instruction ids densely renumbered onto a
        global id axis starting at ``base``, the count of distinct ids);
        order-preserving: ids are non-decreasing per the schema."""
        if not self.n_ops:
            return self, 0
        dense, n = _dense_ids(self.instr)
        return AddressTrace(self.addrs, self.kinds, dense + base, self.mask,
                            self.compute_cycles, dict(self.op_counts),
                            dict(self.meta)), n

    def with_compute(self, compute_cycles: int,
                     op_counts: dict | None = None) -> "AddressTrace":
        return AddressTrace(self.addrs, self.kinds, self.instr, self.mask,
                            compute_cycles=compute_cycles,
                            op_counts=dict(op_counts or {}),
                            meta=dict(self.meta))

    def __repr__(self) -> str:
        return (f"AddressTrace(ops={self.n_ops}, "
                f"instrs={self.n_instructions}, "
                f"compute_cycles={self.compute_cycles})")


def iter_op_chunks(addrs, kind="load", mask=None, block_ops: int | None = None):
    """ONE memory instruction's flat request stream, yielded as
    at-most-``block_ops``-op ``AddressTrace`` blocks.

    The streaming counterpart of ``AddressTrace.from_ops``: continuation
    blocks are ``instr_carry``-marked, so stream consumers renumber them
    onto the same global instruction id and the instruction's controller
    overhead is charged exactly once — a million-index gather streams in
    O(block) memory and costs bit-equal to the dense one-instruction trace.
    Chunk boundaries fall on whole operations, so only the final block pads
    a ragged tail (identically to the dense path)."""
    a = np.asarray(addrs, np.int32).reshape(-1)
    m = None if mask is None else np.asarray(mask, bool).reshape(-1)
    if block_ops is not None and block_ops <= 0:
        raise ValueError(f"block_ops must be positive, got {block_ops}")
    step = None if block_ops is None else block_ops * LANES
    if step is None or a.size <= step:
        yield AddressTrace.from_ops(a, kind, mask=m)
        return
    for start in range(0, a.size, step):
        blk = AddressTrace.from_ops(
            a[start:start + step], kind,
            mask=None if m is None else m[start:start + step])
        if start:
            blk.meta["instr_carry"] = True
        yield blk


class TraceBuilder:
    """Incremental AddressTrace construction with the ISA's accounting rules:
    one ``load``/``store`` call = one instruction (one overhead), compute
    bundles cost ``Σcounts × T/16`` cycles (1 for scalar bundles)."""

    def __init__(self, n_threads: int = LANES):
        self.n_threads = n_threads
        self._chunks: list[AddressTrace] = []
        self._compute_cycles = 0
        self._op_counts: dict = {}

    def load(self, addrs, space: str = "D", mask=None) -> "TraceBuilder":
        kind = "tw" if space == "TW" else "load"
        self._chunks.append(AddressTrace.from_ops(addrs, kind, mask=mask))
        return self

    def store(self, addrs, mask=None) -> "TraceBuilder":
        self._chunks.append(AddressTrace.from_ops(addrs, "store", mask=mask))
        return self

    def compute(self, counts: dict, scalar: bool = False) -> "TraceBuilder":
        per = 1 if scalar else max(1, self.n_threads // LANES)
        self._compute_cycles += sum(counts.values()) * per
        for k, v in counts.items():
            self._op_counts[k] = self._op_counts.get(k, 0) + v * per
        return self

    def build(self, meta: dict | None = None) -> AddressTrace:
        t = AddressTrace.concat(*self._chunks)
        t = t.with_compute(self._compute_cycles, self._op_counts)
        if meta:
            t.meta.update(meta)
        return t


class TraceStream:
    """A lazy sequence of ``AddressTrace`` blocks — the streaming
    implementation of the ``Trace`` protocol (the counterpart of one big
    concatenated trace).

    Costing a stream through ``repro_torch.core.cost_engine.cost_many`` is
    bit-equal to costing its dense ``materialize()`` but touches one block
    at a time, so a >1e6-op serving or kernel trace never materializes its
    dense (ops × 16) matrix.

    Sources vs blocks: the constructor takes *source* blocks — independent
    traces with LOCAL instruction ids and summing compute metadata, plus
    optional ``instr_carry``-marked continuation chunks (see
    ``iter_op_chunks``).  ``blocks(block_ops)`` renumbers them onto one
    global instruction id axis as it yields (further chunking each source to
    at most ``block_ops`` ops), which is what the cost engine consumes.

    ``blocks`` may be a sequence of traces or a zero-arg callable returning
    a fresh iterator — pass a callable (e.g. a generator *function*) when
    the stream must be re-iterable AND produced on demand.  A bare one-shot
    iterator (e.g. a called generator) stays lazy — blocks are drawn as
    they are costed, nothing is held alive — but supports a single pass: a
    second iteration raises instead of silently yielding nothing (the
    pre-refactor footgun, where ``ServeEngine``-style
    ``lambda: iter(gen)`` wrappers priced an empty second pass as 0
    cycles).
    """

    def __init__(self, blocks, meta: dict | None = None):
        if not callable(blocks) and not hasattr(blocks, "__iter__"):
            raise TypeError(
                f"TraceStream needs an iterable of AddressTrace blocks "
                f"or a zero-arg callable returning one, got {blocks!r}")
        self._blocks = blocks
        self._thunks: tuple | None = None
        self._consumed = False
        self.meta = dict(meta or {})

    @classmethod
    def from_thunks(cls, thunks, meta: dict | None = None) -> "TraceStream":
        """A stream whose source blocks are built by independent zero-arg
        callables, one block (or an iterable of blocks) per thunk, consumed
        in thunk order.

        Separate thunks, not one generator, are what let
        ``cost_many(..., prefetch=N)`` build blocks on a worker pool while
        the device prices earlier ones.  Thunks must be independent: each
        may run on any thread, in any order relative to the others.
        Iterating the stream serially calls them in order on the caller's
        thread, so the serial and prefetched passes see the same blocks."""
        thunks = tuple(thunks)
        for t in thunks:
            if not callable(t):
                raise TypeError(f"from_thunks needs zero-arg callables, "
                                f"got {t!r}")

        def gen():
            for t in thunks:
                out = t()
                if isinstance(out, AddressTrace):
                    yield out
                else:
                    yield from out

        stream = cls(gen, meta=meta)
        stream._thunks = thunks
        return stream

    @property
    def thunks(self) -> tuple | None:
        """The construction thunks of a ``from_thunks`` stream (the
        prefetch pipeline's handle on its parallelism), else None."""
        return self._thunks

    def __iter__(self):
        """Iterate the raw SOURCE blocks (local instruction ids); use
        ``blocks()`` for the globally renumbered protocol iteration."""
        if callable(self._blocks):
            return iter(self._blocks())
        if iter(self._blocks) is self._blocks:   # one-shot iterator source
            if self._consumed:
                raise RuntimeError(
                    "this TraceStream wraps a one-shot iterator that was "
                    "already consumed; pass a sequence of blocks or a "
                    "zero-arg callable (e.g. the generator FUNCTION, not a "
                    "called generator) for a re-iterable stream")
            self._consumed = True
            return iter(self._blocks)
        return iter(self._blocks)

    # -- the Trace protocol ------------------------------------------------

    @property
    def n_ops(self) -> int | None:
        """Total op count when cheaply knowable (sequence-backed streams),
        else ``meta["n_ops"]`` if the producer recorded it, else None
        (counting would consume lazy / one-shot sources)."""
        if (not callable(self._blocks)
                and iter(self._blocks) is not self._blocks):
            return sum(b.n_ops for b in self._blocks)
        n = self.meta.get("n_ops")
        return None if n is None else int(n)

    def blocks(self, block_ops: int | None = None):
        """The Trace protocol: yield the stream's blocks with instruction
        ids renumbered onto one global, non-decreasing axis
        (``instr_carry``-marked continuation chunks glue to the previous
        block's last instruction), each source further chunked to at most
        ``block_ops`` ops.  Costing the result is bit-equal to costing the
        dense ``materialize()``."""
        off = 0
        seen_ids = False
        for src in self:
            if not src.n_ops:
                if src.compute_cycles or src.op_counts:
                    yield src
                continue
            _check_instr_monotonic(src, "TraceStream.blocks")
            carry = seen_ids and bool(src.meta.get("instr_carry"))
            base = off - 1 if carry else off
            renum, n_instr = src._renumbered(base)
            off = base + n_instr
            seen_ids = True
            yield from renum.blocks(block_ops)

    # -- parity with AddressTrace ------------------------------------------

    @classmethod
    def concat(cls, *traces, meta: dict | None = None) -> "TraceStream":
        """Compose traces and/or streams back-to-back into one lazy stream
        (the streaming counterpart of ``AddressTrace.concat``)."""
        parts = [as_trace(t) for t in traces]

        def gen():
            for p in parts:
                if isinstance(p, TraceStream):
                    yield from p            # raw sources keep their contract
                else:
                    yield p                 # a dense trace is one source

        return cls(gen, meta=dict(meta or {}))

    def of_kind(self, kind) -> "TraceStream":
        """Memory-only sub-stream of one op kind (compute metadata dropped,
        like ``AddressTrace.of_kind``).  Exact whenever instructions are
        single-kind — true for every producer in this repo."""
        code = _kind_code(kind)

        def gen():
            for b in self:
                yield b.of_kind(code)

        return TraceStream(gen, meta={**self.meta, "kind": code})

    def loads(self) -> "TraceStream":
        return self.of_kind(KIND_LOAD)

    def stores(self) -> "TraceStream":
        return self.of_kind(KIND_STORE)

    def tw_loads(self) -> "TraceStream":
        return self.of_kind(KIND_TW)

    def materialize(self) -> AddressTrace:
        """Concatenate the whole stream into one dense trace (for tests and
        small streams; defeats the purpose for >1e6-op traffic).  Built from
        the renumbered ``blocks()``, so carry-marked continuation chunks
        merge into single instructions exactly as the engine counts them."""
        blks = list(self.blocks())
        counts: dict = {}
        for b in blks:
            for k, v in b.op_counts.items():
                counts[k] = counts.get(k, 0) + v
        compute = sum(b.compute_cycles for b in blks)
        nonempty = [b for b in blks if b.n_ops]
        if not nonempty:
            t = AddressTrace.empty().with_compute(compute, counts)
            t.meta.update(self.meta)
            return t
        any_mask = any(b.mask is not None for b in nonempty)
        masks = [np.ones_like(b.addrs, bool) if b.mask is None else b.mask
                 for b in nonempty] if any_mask else None
        t = AddressTrace(np.concatenate([b.addrs for b in nonempty]),
                         np.concatenate([b.kinds for b in nonempty]),
                         np.concatenate([b.instr for b in nonempty]),
                         np.concatenate(masks) if any_mask else None,
                         compute_cycles=compute, op_counts=counts,
                         meta=dict(self.meta))
        return t

    def __repr__(self) -> str:
        return f"TraceStream(meta={self.meta})"
