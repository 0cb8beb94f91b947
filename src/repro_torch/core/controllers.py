"""Read/write issue-controller timing constants and instruction cycles
(paper §III.A; port of ``repro.core.controllers``).

The paper's cycle tables bundle the controller pipeline into a fixed
per-*instruction* overhead, calibrated against Tables II/III: 40 cycles
for loads and 30 for stores on 16 banks, less on fewer banks (shallower
crossbars).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

# Pipeline constants (cycles), calibrated against Tables II/III.
ISSUE_LATENCY = 5          # sort-network pipeline before first issue
BANK_RAM_LATENCY = 3       # M20K read latency
XBAR_IN_LATENCY = 3        # one-hot address/data input muxes
XBAR_OUT_LATENCY = 3       # output muxes back to lanes
WRITEBACK_LATENCY = 2      # SP register-file writeback

READ_FIXED = 10
READ_OVERHEAD = 30 + READ_FIXED   # per-instruction read overhead (16 banks)
WRITE_OVERHEAD = 30               # per-instruction write overhead (16 banks)

#: crossbar depth varies with bank count (Table II's banked store/load rows)
READ_OVERHEADS = {16: 40, 8: 34, 4: 32}
WRITE_OVERHEADS = {16: 30, 8: 24, 4: 22}

MAX_THREADS_PER_BLOCK = 1024      # paper's thread-block cap (32×32 elements)


def read_overhead(n_banks: int) -> int:
    return READ_OVERHEADS.get(n_banks, READ_OVERHEAD)


def write_overhead(n_banks: int) -> int:
    return WRITE_OVERHEADS.get(n_banks, WRITE_OVERHEAD)


@dataclass(frozen=True)
class InstrTiming:
    """Cycles for one memory instruction, pre/post-overlap accounting."""
    issue_cycles: int      # cycles the instruction occupies the issue pipe
    drain_cycles: int      # extra cycles until data is fully committed
    blocking: bool         # True: fetch/decode stalls for issue+drain

    @property
    def total(self) -> int:
        return self.issue_cycles + self.drain_cycles


def read_instruction_cycles(op_cycles: torch.Tensor) -> torch.Tensor:
    """Total cycles a banked-memory *read* instruction holds the pipeline.

    op_cycles: (ops,) per-operation max-conflict counts.
    """
    return op_cycles.sum() + READ_OVERHEAD


def write_instruction_cycles(op_cycles: torch.Tensor,
                             blocking: bool = True) -> torch.Tensor:
    """Total cycles for a banked *write* instruction.

    Non-blocking writes still consume issue bandwidth equal to their
    conflict cycles (the memory is busy) but release fetch/decode
    immediately; the timeline accumulator models the overlap, so here we
    return the occupancy.
    """
    del blocking
    return op_cycles.sum() + WRITE_OVERHEAD


def multiport_read_cycles(n_ops: int, n_read_ports: int,
                          lanes: int = 16) -> int:
    """Deterministic multi-port read: 16 requests / n ports per op."""
    per_op = -(-lanes // n_read_ports)  # ceil
    return n_ops * per_op


def multiport_write_cycles(n_ops: int, n_write_ports: int,
                           lanes: int = 16) -> int:
    per_op = -(-lanes // n_write_ports)
    return n_ops * per_op
