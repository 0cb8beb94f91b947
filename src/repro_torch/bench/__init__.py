"""Declarative benchmark layer (port of ``repro.bench``).

``sweep(archs, workloads)`` prices every (architecture × workload) cell on
the card and returns tidy records; ``paper_tables`` formats the paper's
Tables II and III over it.  Workloads are ISA programs (``Workload`` — the
paper's transpose/FFT builders) or per-architecture trace lowerings
(``TraceWorkload`` — paged-KV serving traffic, scheduled serving days
and whole-model decode steps).
"""
from repro_torch.bench.runner import (TraceWorkload, Workload, run_cell,
                                      run_cells, sweep, verify_workload)
from repro_torch.bench.workloads import (fft_workload, model_workload,
                                         scheduler_workload,
                                         serving_workload, transpose_workload)

__all__ = ["Workload", "TraceWorkload", "run_cell", "run_cells", "sweep",
           "verify_workload", "fft_workload", "transpose_workload",
           "serving_workload", "scheduler_workload", "model_workload"]
