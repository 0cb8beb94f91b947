"""Macro-op ISA for the trace-functional SIMT VM (port of
``repro.isa.assembler``; host-side numpy, as in the reference).

The paper benchmarks hand-written assembler.  The sources are unpublished, so
we reconstruct the programs at *macro-op* granularity: each instruction either
moves memory (with an explicit per-thread address vector — the trace) or
computes (with an instruction-count template and a vectorized semantic
function).  This preserves exactly what the paper measures:

  * memory instructions produce the (ops × 16 lanes) address matrices the
    issue controllers see — cycle costs come from the cost engine
    (``repro_torch.core.cost_engine``);
  * compute instructions are counted in the four Table II/III buckets
    (FP / INT / Immediate / Other); each instruction over T threads costs
    T/16 cycles (16 SPs);
  * the semantic functions make the program *actually run* — results are
    asserted against numpy oracles in tests (FFT vs numpy.fft.fft,
    transpose vs x.T).

Thread blocks are capped at 1024 threads (paper; a 64×64 transpose runs as
4 sequential blocks — this reproduces Table II's 4×(1024+30) store rows).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from repro_torch.core.memsim import LANES

Regs = dict  # name -> np.ndarray of per-thread values


@dataclass(frozen=True)
class MemLoad:
    """Load one or more words per thread.  space: 'D' (data) or 'TW' (twiddle).

    Multi-word form (reg = tuple of k names, addrs = (k, T)): a single
    instruction issuing k sequential requests per SP — one instruction
    overhead, k·T/16 operations.  The paper's complex (I/Q) accesses are
    2-word instructions; this is what makes Table III's banked columns
    reproduce cycle-exactly (see DESIGN.md §1).
    """
    reg: str | tuple
    addrs: np.ndarray            # (T,) or (k, T) int32 word addresses
    space: str = "D"
    blocking: bool = True        # reads always block (paper §III.A)


@dataclass(frozen=True)
class MemStore:
    reg: str | tuple
    addrs: np.ndarray            # (T,) or (k, T) int32
    blocking: bool = False       # non-blocking unless data reused immediately


@dataclass(frozen=True)
class Compute:
    """A bundle of ALU instructions with one semantic function.

    counts: instructions per thread in Table buckets, e.g. {"fp": 6} for one
    complex multiply (4 FMUL + 2 FADD).
    fn: vectorized (regs) -> regs update, or None for pure-cost instructions
    (address generation the VM performs implicitly through the trace).
    """
    counts: dict
    fn: Callable[[Regs], Regs] | None = None
    label: str = ""
    scalar: bool = False   # scalar/control ops cost 1 cycle, not T/16


Instr = MemLoad | MemStore | Compute


@dataclass
class Program:
    """A straight-line macro-op program over a fixed thread count."""
    name: str
    n_threads: int
    instrs: list = field(default_factory=list)
    meta: dict = field(default_factory=dict)

    def load(self, reg, addrs: np.ndarray, space: str = "D",
             blocking: bool = True) -> None:
        self.instrs.append(MemLoad(reg, np.asarray(addrs, np.int32), space,
                                   blocking))

    def store(self, reg, addrs: np.ndarray, blocking: bool = False) -> None:
        self.instrs.append(MemStore(reg, np.asarray(addrs, np.int32), blocking))

    def compute(self, counts: dict, fn=None, label: str = "",
                scalar: bool = False) -> None:
        self.instrs.append(Compute(dict(counts), fn, label, scalar))

    # -- accounting ---------------------------------------------------------

    def op_counts(self) -> dict:
        """Total instruction counts per bucket (instructions × 1, not cycles)."""
        tot = {"fp": 0, "int": 0, "imm": 0, "other": 0}
        for i in self.instrs:
            if isinstance(i, Compute):
                for k, v in i.counts.items():
                    tot[k] += v
        return tot

    def compute_cycles(self) -> int:
        """Cycles spent in ALU instructions: Σ counts × T/16 per instruction."""
        cyc = 0
        for i in self.instrs:
            if isinstance(i, Compute):
                n = sum(i.counts.values())
                cyc += n * (1 if i.scalar else _cycles_per_instr(self.n_threads))
        return cyc

    def address_trace(self):
        """The program's first-class ``AddressTrace`` (core.trace) —
        the artifact ``MemoryArchitecture.cost`` consumes."""
        from repro_torch.core.trace import AddressTrace
        return AddressTrace.from_program(self)

    def mem_traces(self) -> tuple[list, list, list]:
        """(load, store, tw) lists of (ops, LANES) address matrices."""
        loads, stores, tws = [], [], []
        for i in self.instrs:
            if isinstance(i, MemLoad):
                (tws if i.space == "TW" else loads).append(to_ops(i.addrs))
            elif isinstance(i, MemStore):
                stores.append(to_ops(i.addrs))
        return loads, stores, tws


def _cycles_per_instr(n_threads: int) -> int:
    return max(1, n_threads // LANES)


def op_count_cycles(counts: dict, n_threads: int) -> dict:
    """Instruction counts -> Table II/III 'Common Ops' cycle buckets."""
    c = _cycles_per_instr(n_threads)
    return {k: v * c for k, v in counts.items()}


def to_ops(addrs: np.ndarray) -> np.ndarray:
    """(T,) or (k, T) per-thread addresses -> (ops, 16) operation matrix.

    Multi-word instructions issue word 0 for all threads, then word 1, ... —
    each word is its own sequence of 16-lane operations (C-order reshape).
    Delegates to ``core.trace.as_ops`` (the AddressTrace schema owns
    the op-grouping rule since the cost-API redesign).
    """
    from repro_torch.core.trace import as_ops
    return as_ops(addrs)
