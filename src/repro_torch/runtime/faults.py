"""Seeded, deterministic fault plans for the serving stack (port of
``repro.runtime.faults``).

The paper's banked memories live in FPGA block RAMs, where single-event
upsets and partial reconfiguration make *bank loss* and *word corruption*
operating conditions rather than crashes.  This module is the injection
side of the recovery layer:

  * ``FaultEvent`` — one fault on the scheduler's tick timeline.  Kinds:

      - ``bank_offline``      a whole pool bank stops accepting traffic;
                              live pages migrate to surviving banks and the
                              pool enters degraded mode
                              (``repro_torch.core.arch`` ``!d`` variants
                              price the remapped layout);
      - ``page_corrupt``      one resident page's words fail ECC parity;
                              the owning request is re-prefilled and its
                              decode steps replayed from the recorded
                              tokens (bit-exact by lane independence);
      - ``decode_transient``  a decode step fails ``failures`` times before
                              succeeding; the live engine drives it through
                              ``runtime.fault_tolerance.retry_step``;
      - ``preempt``           a preemption signal: the live engine
                              checkpoints scheduler + pools and returns;
                              a second call resumes the day.

  * ``FaultPlan``  — an immutable, tick-ordered event sequence.  The
    scheduler consumes events with ``tick <= now`` through a cursor it owns
    (idle fast-forwards may skip tick values; the events still fire, in
    order, at the next tick that runs), so replaying a plan on a fresh
    scheduler — how ``simulate_scheduler_stream`` re-iterates a faulted
    day — is deterministic by construction.
  * ``FaultPlan.synthesize`` — a seeded chaos generator over a tick
    horizon (chaos matrices and the serving bench's chaos gate draw their
    days from here).

A plan is pure data that the serving control plane
(``repro_torch.serving.scheduler`` / ``ServeEngine.run_scheduler``)
interprets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultPlan", "TransientFault"]

FAULT_KINDS = ("bank_offline", "page_corrupt", "decode_transient", "preempt")


class TransientFault(RuntimeError):
    """The injected decode-step failure ``retry_step`` retries through (a
    ``RuntimeError`` so production ``retry_on`` defaults also catch it)."""


@dataclass(frozen=True)
class FaultEvent:
    """One fault on the scheduler tick timeline.

    Field use per kind: ``bank_offline`` reads ``bank``; ``page_corrupt``
    reads ``rid`` (the victim request) and ``page_idx`` (ordinal into the
    victim's live page list, taken modulo its length); ``decode_transient``
    reads ``failures`` (injected failures before success); ``preempt`` has
    no payload.  Unused fields keep their -1/0 defaults.
    """
    tick: int
    kind: str
    bank: int = -1
    rid: int = -1
    page_idx: int = 0
    failures: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; choose "
                             f"from {FAULT_KINDS}")
        if self.tick < 0:
            raise ValueError(f"fault tick must be >= 0, got {self.tick}")
        if self.kind == "bank_offline" and self.bank < 0:
            raise ValueError("bank_offline needs a bank index")
        if self.kind == "page_corrupt" and self.rid < 0:
            raise ValueError("page_corrupt needs a victim rid")
        if self.kind == "decode_transient" and self.failures < 1:
            raise ValueError("decode_transient needs failures >= 1")


@dataclass(frozen=True)
class FaultPlan:
    """An immutable, tick-ordered fault sequence for one serving day.

    The plan itself is stateless — consumers (one ``Scheduler`` per live
    run or simulation pass) walk it with their own cursor via ``due``, so
    one plan can drive any number of deterministic replays.
    """
    events: tuple = ()

    def __post_init__(self):
        evs = tuple(self.events)
        if list(evs) != sorted(evs, key=lambda e: e.tick):
            raise ValueError("fault events must be tick-ordered")
        object.__setattr__(self, "events", evs)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def due(self, now: int, cursor: int) -> tuple:
        """Events that fire at tick ``now`` given a consumer's ``cursor``
        (count of events already applied): every not-yet-applied event with
        ``tick <= now`` — the ``<=`` is what survives idle fast-forwards
        that skip tick values.  Returns ``(events, new_cursor)``."""
        out = []
        while cursor < len(self.events) and self.events[cursor].tick <= now:
            out.append(self.events[cursor])
            cursor += 1
        return tuple(out), cursor

    def counts(self) -> dict:
        """Event-kind histogram (bench/report metadata)."""
        c: dict = {}
        for e in self.events:
            c[e.kind] = c.get(e.kind, 0) + 1
        return c

    @property
    def has_preempt(self) -> bool:
        return any(e.kind == "preempt" for e in self.events)

    @classmethod
    def synthesize(cls, seed: int, n_events: int = 3, horizon: int = 32,
                   kinds: tuple = ("bank_offline", "page_corrupt",
                                   "decode_transient"),
                   n_banks: int = 16, n_rids: int = 8,
                   max_failures: int = 2) -> "FaultPlan":
        """A seeded chaos day: ``n_events`` faults at distinct ticks drawn
        uniformly from ``[1, horizon)``, kinds cycled deterministically
        through ``kinds`` with seeded payloads (bank < ``n_banks`` — never
        the last bank, which hosts the reserved scratch page; victim rid <
        ``n_rids``).  Same (seed, args) → same plan, always."""
        rng = np.random.default_rng(seed)
        ticks = sorted(rng.choice(np.arange(1, max(2, horizon)),
                                  size=min(n_events, max(1, horizon - 1)),
                                  replace=False).tolist())
        events = []
        for i, t in enumerate(ticks):
            kind = kinds[i % len(kinds)]
            events.append(FaultEvent(
                tick=int(t), kind=kind,
                bank=int(rng.integers(0, max(1, n_banks - 1))),
                rid=int(rng.integers(0, n_rids)),
                page_idx=int(rng.integers(0, 8)),
                failures=int(rng.integers(1, max_failures + 1))))
        return cls(events=tuple(events))
