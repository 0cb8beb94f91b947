"""Read/write issue-controller timing constants (paper §III.A; port of
``repro.core.controllers``).

The paper's cycle tables bundle the controller pipeline into a fixed
per-*instruction* overhead, calibrated against Tables II/III: 40 cycles
for loads and 30 for stores on 16 banks, less on fewer banks (shallower
crossbars).
"""
from __future__ import annotations

READ_FIXED = 10
READ_OVERHEAD = 30 + READ_FIXED   # per-instruction read overhead (16 banks)
WRITE_OVERHEAD = 30               # per-instruction write overhead (16 banks)

#: crossbar depth varies with bank count (Table II's banked store/load rows)
READ_OVERHEADS = {16: 40, 8: 34, 4: 32}
WRITE_OVERHEADS = {16: 30, 8: 24, 4: 22}


def read_overhead(n_banks: int) -> int:
    return READ_OVERHEADS.get(n_banks, READ_OVERHEAD)


def write_overhead(n_banks: int) -> int:
    return WRITE_OVERHEADS.get(n_banks, WRITE_OVERHEAD)
