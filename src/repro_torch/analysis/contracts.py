"""Streaming trace-contract checker (port of
``repro.analysis.contracts``): the Trace protocol's invariants, verified
on every block in O(block) memory.

The cost engine (``repro_torch.core.cost_engine``) charges per-instruction
controller overheads from a streaming distinct-instruction count, which is
only correct when every stream honours the ``repro_torch.core.trace``
protocol: globally non-decreasing instruction ids across blocks, legal
``instr_carry`` continuation chains (a carried block continues the previous
block's last instruction id), shape/kind/mask consistency, and
non-negative addresses (the engine's bank formula relies on
``addr >> 31 == 0``).  Here they are a machine-checked oracle:

  * ``validate(trace, arch)`` — one full pass over any ``Trace`` (dense,
    chunked or streamed); raises ``TraceContractError`` on the first
    violation (or collects them with ``strict=False``) and returns a
    ``ValidationReport`` of what it saw.  For a ``TraceStream`` it checks
    the *source* blocks (local ids, carry marks) and the renumbered
    protocol blocks in the same single pass.
  * ``checked_blocks(iterator)`` — the inline wrapper ``cost_many(...,
    checked=True)`` / ``arch.cost(..., checked=True)`` use: validation and
    costing share one pass, so even one-shot streams can be checked.
  * ``checking()`` — a process-wide switch (context manager): while on,
    every ``cost_many`` call validates the stream it prices.

All of it is host numpy.  Validation never mutates or re-orders blocks, so
a checked stream costs bit-identically to an unchecked one.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from repro_torch.core.memsim import LANES
from repro_torch.core.trace import (KIND_LOAD, KIND_STORE, KIND_TW,
                                    AddressTrace, TraceContractError,
                                    TraceStream, _decreases, _id_runs,
                                    as_trace)

__all__ = ["validate", "checked_blocks", "ValidationReport",
           "TraceContractError", "checking", "set_checking", "is_checking"]

_LEGAL_KINDS = (KIND_LOAD, KIND_STORE, KIND_TW)
_KIND_NAMES = {KIND_LOAD: "load", KIND_STORE: "store", KIND_TW: "tw"}


# --------------------------------------------------------------------------
# Process-wide checking switch
# --------------------------------------------------------------------------

_CHECKING = False


def is_checking() -> bool:
    """True while the process-wide contract-checking switch is on (the
    ``checked=None`` default of ``cost_many`` consults this)."""
    return _CHECKING


def set_checking(on: bool) -> None:
    global _CHECKING
    _CHECKING = bool(on)


@contextlib.contextmanager
def checking(on: bool = True):
    """Context manager: validate every stream ``cost_many`` prices inside
    the block."""
    global _CHECKING
    prev = _CHECKING
    _CHECKING = bool(on)
    try:
        yield
    finally:
        _CHECKING = prev


# --------------------------------------------------------------------------
# Report
# --------------------------------------------------------------------------

@dataclass
class ValidationReport:
    """What one validation pass saw (totals match the cost engine's own
    streaming accounting) plus any collected violations."""
    n_blocks: int = 0
    n_ops: int = 0
    n_instructions: int = 0
    n_ops_by_kind: dict = field(default_factory=dict)
    n_instr_by_kind: dict = field(default_factory=dict)
    compute_cycles: int = 0
    max_addr: int = -1
    n_inactive_lanes: int = 0
    violations: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    def __repr__(self) -> str:
        status = "ok" if self.ok else f"{len(self.violations)} violations"
        return (f"ValidationReport({status}, blocks={self.n_blocks}, "
                f"ops={self.n_ops}, instrs={self.n_instructions})")


# --------------------------------------------------------------------------
# The streaming checker
# --------------------------------------------------------------------------

class _Checker:
    """Shared violation plumbing: raise on the first violation (strict) or
    collect into the report (non-strict)."""

    def __init__(self, report: ValidationReport, strict: bool, where: str):
        self.report = report
        self.strict = strict
        self.where = where

    def fail(self, msg: str) -> None:
        msg = f"{self.where}: {msg}"
        if self.strict:
            raise TraceContractError(msg)
        self.report.violations.append(msg)


class _ProtocolChecker(_Checker):
    """Checks the ``Trace.blocks`` output contract block by block: the ids
    are globally non-decreasing, carries continue the previous id, the
    schema shapes hold, and active-lane addresses are in bounds."""

    def __init__(self, report: ValidationReport, strict: bool = True,
                 n_words: int | None = None, where: str = "trace"):
        super().__init__(report, strict, where)
        self.n_words = None if n_words is None else int(n_words)
        self._prev_last_id: int | None = None
        self._last_id_by_kind: dict = {}

    def check(self, blk) -> None:
        r = self.report
        r.n_blocks += 1
        if not isinstance(blk, AddressTrace):
            self.fail(f"block {r.n_blocks} is {type(blk).__name__}, "
                      f"not AddressTrace")
            return
        r.compute_cycles += int(blk.compute_cycles)
        if blk.compute_cycles < 0:
            self.fail(f"block {r.n_blocks}: negative compute_cycles "
                      f"{blk.compute_cycles}")
        if not blk.n_ops:
            return
        self._check_shapes(blk)
        self._check_kinds(blk)
        self._check_instrs(blk)
        self._check_addrs(blk)
        self._prev_last_id = int(blk.instr[-1])

    # -- individual contracts ---------------------------------------------

    def _check_shapes(self, blk) -> None:
        n = blk.addrs.shape[0]
        if blk.addrs.ndim != 2 or blk.addrs.shape[1] != LANES:
            self.fail(f"addrs shape {blk.addrs.shape} is not (ops, {LANES})")
        if blk.kinds.shape != (n,) or blk.instr.shape != (n,):
            self.fail(f"kinds/instr shapes {blk.kinds.shape}/"
                      f"{blk.instr.shape} disagree with {n} ops")
        if blk.mask is not None:
            if blk.mask.shape != blk.addrs.shape:
                self.fail(f"mask shape {blk.mask.shape} != addrs shape "
                          f"{blk.addrs.shape}")
            elif blk.mask.dtype != np.bool_:
                self.fail(f"mask dtype {blk.mask.dtype} is not bool")

    def _check_kinds(self, blk) -> None:
        r = self.report
        bad = ~np.isin(blk.kinds, _LEGAL_KINDS)
        if bad.any():
            self.fail(f"illegal op kind(s) "
                      f"{sorted(set(blk.kinds[bad].tolist()))} (legal: "
                      f"{list(_LEGAL_KINDS)})")
        for k in _LEGAL_KINDS:
            c = int((blk.kinds == k).sum())
            if c:
                name = _KIND_NAMES[k]
                r.n_ops_by_kind[name] = r.n_ops_by_kind.get(name, 0) + c

    def _check_instrs(self, blk) -> None:
        r = self.report
        ids = blk.instr
        if int(ids[0]) < 0:
            self.fail(f"negative instruction id {int(ids[0])}")
        if _decreases(ids):
            self.fail("instruction ids decrease within a block")
        carry = bool(blk.meta.get("instr_carry"))
        if self._prev_last_id is None:
            if carry:
                self.fail("instr_carry on the first ids-bearing block "
                          "(nothing to continue)")
        else:
            if int(ids[0]) < self._prev_last_id:
                self.fail(f"instruction ids decrease across blocks "
                          f"({self._prev_last_id} -> {int(ids[0])})")
            if carry and int(ids[0]) != self._prev_last_id:
                self.fail(f"instr_carry block does not continue the "
                          f"previous instruction (id {int(ids[0])} after "
                          f"{self._prev_last_id})")
            # an id may span kinds, even across a carry: the dense
            # auto-chunker carries whatever instruction the cut lands on,
            # and the engine keys per-kind overhead on (kind, id), so the
            # per-kind memos below stay right and no kind check is made
        # distinct-instruction accounting, by the engine's counting rule
        add, first, _ = _id_runs(ids)
        if self._prev_last_id is not None and first == self._prev_last_id:
            add -= 1
        r.n_instructions += add
        for k in _LEGAL_KINDS:
            sel = blk.kinds == k
            if not sel.any():
                continue
            kadd, kfirst, klast = _id_runs(ids[sel])
            if self._last_id_by_kind.get(k) == kfirst:
                kadd -= 1
            self._last_id_by_kind[k] = klast
            name = _KIND_NAMES[k]
            r.n_instr_by_kind[name] = r.n_instr_by_kind.get(name, 0) + kadd

    def _check_addrs(self, blk) -> None:
        r = self.report
        r.n_ops += blk.n_ops
        active = (np.ones_like(blk.addrs, bool) if blk.mask is None
                  else blk.mask)
        r.n_inactive_lanes += int((~active).sum())
        if not active.any():
            return
        act_addrs = blk.addrs[active]
        lo, hi = int(act_addrs.min()), int(act_addrs.max())
        r.max_addr = max(r.max_addr, hi)
        if lo < 0:
            self.fail(f"negative address {lo} on an active lane (the "
                      f"engine's bank formula requires addr >> 31 == 0)")
        if self.n_words is not None and hi >= self.n_words:
            self.fail(f"address {hi} out of bounds for {self.n_words} "
                      f"words")


class _SourceChecker(_Checker):
    """Checks a ``TraceStream``'s raw source blocks (local instruction ids):
    the carry marks that glue one instruction across sources are legal."""

    def __init__(self, report: ValidationReport, strict: bool = True,
                 where: str = "stream source"):
        super().__init__(report, strict, where)
        self._prev_kind: int | None = None
        self._seen_ids = False

    def wrap(self, sources) -> Iterator:
        for i, src in enumerate(sources):
            self.check_source(src, i)
            yield src

    def check_source(self, src, i: int) -> None:
        if not isinstance(src, AddressTrace):
            self.fail(f"source block {i} is {type(src).__name__}, "
                      f"not AddressTrace")
            return
        if not src.n_ops:
            if src.meta.get("instr_carry"):
                self.fail(f"source block {i}: instr_carry on a memory-less "
                          f"(compute-only) block")
            return
        if _decreases(src.instr):
            self.fail(f"source block {i}: local instruction ids decrease")
        if src.meta.get("instr_carry"):
            if not self._seen_ids:
                self.fail(f"source block {i}: instr_carry on the first "
                          f"ids-bearing source (nothing to continue)")
            elif self._prev_kind is not None and (
                    int(src.kinds[0]) != self._prev_kind):
                self.fail(f"source block {i}: carried instruction changes "
                          f"kind ({self._prev_kind} -> "
                          f"{int(src.kinds[0])})")
        self._seen_ids = True
        self._prev_kind = int(src.kinds[-1])


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------

def checked_blocks(blocks, n_words: int | None = None, strict: bool = True,
                   report: ValidationReport | None = None,
                   where: str = "checked_blocks") -> Iterator[AddressTrace]:
    """Wrap a ``Trace.blocks`` iterator: validate each protocol block as it
    passes through, unchanged.  This is how ``cost_many(..., checked=True)``
    checks one-shot streams: validation and costing share the single pass
    the stream supports."""
    checker = _ProtocolChecker(report or ValidationReport(), strict=strict,
                               n_words=n_words, where=where)
    for blk in blocks:
        checker.check(blk)
        yield blk


def validate(trace, arch=None, *, block_ops: int | None = None,
             n_words: int | None = None,
             strict: bool = True) -> ValidationReport:
    """Validate any ``repro_torch.core.trace.Trace`` against the protocol
    contract in one streaming pass (O(block) memory).

    ``arch`` (a name / spec / ``MemoryArchitecture``) is accepted for
    call-site symmetry with ``arch.cost`` and only resolved (an unknown
    name fails fast); the address-bound check uses ``n_words`` (explicit,
    or ``trace.meta["n_words"]`` when the producer recorded it).

    ``strict=True`` (default) raises ``TraceContractError`` on the first
    violation; ``strict=False`` collects every violation into the returned
    ``ValidationReport``.  Validation consumes one pass: a one-shot stream
    cannot be costed afterwards (validate while costing instead, with
    ``cost_many(..., checked=True)``).
    """
    if arch is not None:
        from repro_torch.core import arch as _arch
        _arch.resolve(arch)
    t = as_trace(trace)
    if n_words is None:
        n_words = t.meta.get("n_words") if isinstance(t.meta, dict) else None
    report = ValidationReport()
    if isinstance(t, TraceStream):
        # check raw sources and renumbered protocol blocks in ONE pass:
        # the wrapped stream re-applies TraceStream's own renumbering
        src_checker = _SourceChecker(report, strict=strict)
        inner = t
        t = TraceStream(lambda: src_checker.wrap(iter(inner)),
                        meta=dict(inner.meta))
    for _ in checked_blocks(t.blocks(block_ops), n_words=n_words,
                            strict=strict, report=report, where="validate"):
        pass
    return report
