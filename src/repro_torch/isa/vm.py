"""Trace-functional SIMT VM: executes macro-op programs and costs them under
any memory architecture (banked or multi-port); port of ``repro.isa.vm``.

Functional state: a flat float32 word memory plus a per-thread register
file (host numpy, vectorized over threads — the VM is the simulated
processor, so it runs where the reference runs it).  Timing:
the program lowers to the **same first-class ``repro_torch.core.trace.Trace``**
the kernel registry's generators emit — streamed block-by-block
(``instr_trace_blocks`` / ``program_trace_stream``) as the instruction list
is walked, never concatenated into one dense (ops × 16) matrix — then
costed by ``MemoryArchitecture.cost`` on ``device`` (the cost engine's
per-op conflict arithmetic runs on the card unless the caller passes
``device="cpu"``).  Kernel-derived and VM-derived cycle
counts therefore share a single timing path and cross-validate on the
Table II/III programs.

``run_program`` returns the final memory (for oracle checks), the trace
stream it costed (``VMResult.trace_stream``; ``VMResult.trace``
materializes the dense ``AddressTrace`` on demand), and a ``TraceCost``
identical in structure to the rows of Tables II/III.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.memsim import LANES, MemSpec, TraceCost
from repro_torch.core.trace import AddressTrace, TraceStream, iter_op_chunks
from repro_torch.isa.assembler import Compute, MemLoad, MemStore, Program


@dataclass
class VMResult:
    memory: np.ndarray        # final word memory
    regs: dict                # final register file
    cost: TraceCost
    fmax_mhz: float
    #: the costed Trace (lazy; one block at a time — see module docstring)
    trace_stream: TraceStream | None = None
    _trace: AddressTrace | None = field(default=None, repr=False)

    @property
    def trace(self) -> AddressTrace | None:
        """The costed address trace, materialized on demand (the VM costs
        the stream; the dense concatenation exists only if you ask)."""
        if self._trace is None and self.trace_stream is not None:
            # lint: allow-materialize — on-demand dense view, never costed
            self._trace = self.trace_stream.materialize()
        return self._trace

    @property
    def total_cycles(self) -> int:
        return self.cost.total_cycles

    @property
    def time_us(self) -> float:
        return self.cost.time_us(self.fmax_mhz)


def instr_trace_blocks(instrs, n_threads: int, block_ops: int | None = None):
    """Lower a macro-op instruction iterable to ``TraceStream`` source
    blocks as it is consumed — the streaming construction path.

    One memory instruction becomes one run of at-most-``block_ops``-op
    blocks (continuation chunks ``instr_carry``-marked, so the instruction's
    controller overhead is charged once; see ``repro_torch.core.trace``); one
    compute bundle becomes a memory-less block carrying its cycle/op-count
    contribution (the same ``Σcounts × T/16`` accounting as
    ``TraceBuilder.compute``).  Costing the blocks is bit-equal to costing
    ``AddressTrace.from_program`` of the same instructions.
    """
    for ins in instrs:
        if isinstance(ins, MemLoad):
            kind = "tw" if ins.space == "TW" else "load"
            yield from iter_op_chunks(ins.addrs, kind, block_ops=block_ops)
        elif isinstance(ins, MemStore):
            yield from iter_op_chunks(ins.addrs, "store", block_ops=block_ops)
        elif isinstance(ins, Compute):
            per = 1 if ins.scalar else max(1, n_threads // LANES)
            cycles = sum(ins.counts.values()) * per
            counts = {k: v * per for k, v in ins.counts.items()}
            yield AddressTrace.empty().with_compute(cycles, counts)
        else:  # pragma: no cover
            raise TypeError(f"unknown instruction {ins!r}")


def program_trace_stream(program: Program,
                         block_ops: int | None = None) -> TraceStream:
    """A macro-op program's address trace as a lazy, re-iterable
    ``TraceStream`` (pure function of the program — cost it under any
    architecture with ``arch.cost`` / ``cost_many`` without ever holding
    more than one block)."""
    return TraceStream(
        lambda: instr_trace_blocks(program.instrs, program.n_threads,
                                   block_ops),
        meta={"program": program.name, **program.meta})


def program_trace(program: Program) -> AddressTrace:
    """Lower a macro-op program to its dense AddressTrace (the
    materialization of ``program_trace_stream``; prefer the stream for
    costing — it is bit-equal and O(block) in memory)."""
    return AddressTrace.from_program(program)


def run_program(program: Program, spec: MemSpec, init_memory: np.ndarray,
                execute: bool = True, device="cuda") -> VMResult:
    """Run (and/or cost) a program against one memory architecture; the
    pricing runs on ``device``, the functional execution on the host.

    execute=False skips the functional part (timing only) — used when costing
    the same trace under many architectures.
    """
    from repro_torch.core import arch as _arch

    stream = program_trace_stream(program)
    cost = _arch.from_spec(spec).cost(stream, device=device)

    mem = np.array(init_memory, np.float32, copy=True)
    regs: dict = {}
    if execute:
        for instr in program.instrs:
            if isinstance(instr, MemLoad):
                if isinstance(instr.reg, tuple):
                    for i, r in enumerate(instr.reg):
                        regs[r] = mem[np.asarray(instr.addrs[i], np.int64)]
                else:
                    regs[instr.reg] = mem[np.asarray(instr.addrs, np.int64)]
            elif isinstance(instr, MemStore):
                if isinstance(instr.reg, tuple):
                    for i, r in enumerate(instr.reg):
                        mem[np.asarray(instr.addrs[i], np.int64)] = np.asarray(
                            regs[r], np.float32)
                else:
                    mem[np.asarray(instr.addrs, np.int64)] = np.asarray(
                        regs[instr.reg], np.float32)
            elif isinstance(instr, Compute):
                if instr.fn is not None:
                    regs = instr.fn(regs)
            else:  # pragma: no cover
                raise TypeError(f"unknown instruction {instr!r}")

    return VMResult(memory=mem, regs=regs, cost=cost, fmax_mhz=spec.fmax_mhz,
                    trace_stream=stream)


def cost_only(program: Program, spec: MemSpec,
              device="cuda") -> TraceCost:
    """Timing-only pass (no functional execution, no memory needed) —
    streams the program's blocks straight into the cost engine on
    ``device``."""
    from repro_torch.core import arch as _arch
    return _arch.from_spec(spec).cost(program_trace_stream(program),
                                      device=device)
