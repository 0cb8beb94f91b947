"""Matrix-transpose benchmark program (paper Table II); port of
``repro.isa.programs.transpose``, its symbolic-prover hook
(``symbolic_trace``) included.

Reconstruction notes: the paper's assembler is unpublished; the
thread→element mapping below is the one that reproduces the banked columns of
Table II cycle-exactly for the LSB map and within ~2 % for the Offset map:

  * lane j of operation o loads  A[R, p + s·j]   with s = N/16, R = o // s,
    p = o % s  — i.e. a stride-s sweep of one row per s operations.  Under the
    LSB map this yields max-conflict C = s (2/4/8 for N = 32/64/128): Table
    II's 168 / 1184 / 8832 load cycles ✓.
  * the transposed store writes B[c, R] = column-major stride-N·s between
    lanes ⇒ all 16 lanes hit one bank under *both* maps: the ~6.1 % write
    efficiencies and 1054/1050/1048/1046 store rows ✓.
  * thread blocks cap at 1024 threads; larger matrices iterate blocks
    (Table II 64×64 store = 4 × (1024+30) ✓).

Functional semantics: out-of-place transpose, validated against ``x.T``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.memsim import LANES
from repro_torch.isa.assembler import Compute, MemLoad, MemStore, Program

MAX_BLOCK = 1024


def transpose_n_threads(n: int) -> int:
    """Threads per program block (blocks cap at MAX_BLOCK threads)."""
    return min(MAX_BLOCK, n * n)


def _in_addr(t: np.ndarray, n: int) -> np.ndarray:
    s = max(1, n // LANES)
    o, j = t // LANES, t % LANES
    r, p = o // s, o % s
    return r * n + p + s * j


def _out_addr(t: np.ndarray, n: int, out_base: int) -> np.ndarray:
    s = max(1, n // LANES)
    o, j = t // LANES, t % LANES
    r, p = o // s, o % s
    c = p + s * j
    return out_base + c * n + r


def iter_transpose_instrs(n: int):
    """Lazily yield the N×N transpose macro-ops one at a time.

    The single source of the program's content: ``transpose_program``
    materializes this iterator into a ``Program`` (for functional runs),
    while the streaming trace pipeline lowers it block-by-block
    (``isa.vm.instr_trace_blocks``) so a million-op transpose trace is
    constructed AND costed in O(block) memory — the per-block address
    vectors are computed from the closed-form thread→element mapping only
    when their block is drawn.
    """
    total = n * n
    out_base = total
    t_block = transpose_n_threads(n)

    # Address-generation template (calibrated to Table II's 32×32 Common Ops:
    # 4 INT + 2 IMM vector instructions + 1 scalar IMM + 6 scalar-cycle other).
    yield Compute({"imm": 2}, label="load base pointers")
    yield Compute({"int": 4}, label="lane/op address arithmetic")
    yield Compute({"imm": 1, "other": 6}, scalar=True, label="control")

    for b in range(total // t_block):
        t = np.arange(b * t_block, (b + 1) * t_block, dtype=np.int64)
        yield MemLoad("v", np.asarray(_in_addr(t, n), np.int32))
        yield MemStore("v", np.asarray(_out_addr(t, n, out_base), np.int32))


def symbolic_trace(n: int):
    """Closed-form description of this program's traffic for the symbolic
    conflict prover (``repro_torch.analysis.symbolic``): the exact address
    equations of ``_in_addr`` / ``_out_addr`` as two affine lane families.

    With s = N/16, op (r, p) lane j loads ``A[r·N + p + s·j]`` (stride-s row
    sweep) and stores ``B[out_base + (p + s·j)·N + r]`` (column-major, the
    paper's ~6 % write side).  Compute metadata reproduces the three
    ``Compute`` bundles so the proved ``TraceCost`` matches the engine's
    bit-exactly on the whole Table II workload.
    """
    from repro_torch.analysis.symbolic import AffineFamily, SymbolicTrace
    s = max(1, n // LANES)
    total = n * n
    t_block = transpose_n_threads(n)
    n_mem_instrs = total // t_block
    per = max(1, t_block // LANES)
    families = (
        AffineFamily(name=f"transpose{n} row loads", kind="load",
                     const=0, terms=((n, n), (1, s)),
                     offsets=tuple(s * j for j in range(LANES)),
                     n_instructions=n_mem_instrs),
        AffineFamily(name=f"transpose{n} column stores", kind="store",
                     const=total, terms=((n, s), (1, n)),
                     offsets=tuple(s * n * j for j in range(LANES)),
                     n_instructions=n_mem_instrs),
    )
    return SymbolicTrace(
        families=families,
        compute_cycles=6 * per + 7,
        op_counts={"imm": 2 * per + 1, "int": 4 * per, "other": 6},
        meta={"program": f"transpose{n}x{n}", "n": n})


def transpose_program(n: int) -> Program:
    """Build the N×N transpose macro-op program (input at 0, output at N²)."""
    total = n * n
    t_block = transpose_n_threads(n)
    prog = Program(f"transpose{n}x{n}", n_threads=t_block,
                   meta={"n": n, "out_base": total,
                         "blocks": total // t_block})
    prog.instrs = list(iter_transpose_instrs(n))
    return prog


def oracle(n: int, x: np.ndarray) -> np.ndarray:
    """Expected final memory contents: [x, x.T] flattened."""
    a = np.asarray(x, np.float32).reshape(n, n)
    return np.concatenate([a.reshape(-1), a.T.reshape(-1)])
