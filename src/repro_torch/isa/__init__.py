"""Macro-op ISA + trace-functional SIMT VM for the paper's benchmarks
(port of ``repro.isa``)."""
from repro_torch.isa.assembler import (Compute, MemLoad, MemStore, Program,
                                       op_count_cycles, to_ops)
from repro_torch.isa.vm import VMResult, cost_only, run_program

__all__ = ["Compute", "MemLoad", "MemStore", "Program", "op_count_cycles",
           "to_ops", "VMResult", "run_program", "cost_only"]
