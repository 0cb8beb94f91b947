"""Declarative sweep runner: (architectures × workloads) -> tidy records
(port of ``repro.bench.runner``; the pricing runs on ``device``, the card
unless the caller passes ``device="cpu"``).

One ``Workload`` wraps an ISA program plus its initial memory image and an
optional functional oracle.  ``sweep`` costs every cell of the comparison
surface (the paper is 9 architectures × 51 benchmarks) and returns one flat
dict per cell — ready for CSV printing, pandas, or the paper-table
formatters in ``repro_torch.bench.paper_tables``.

    from repro_torch.bench import sweep, transpose_workload
    recs = sweep(["16B-offset", "4R-2W"], [transpose_workload(32)])
    recs[0]["total_cycles"], recs[0]["time_us"]

Architectures may be given as ``MemoryArchitecture`` objects, ``MemSpec``
values, or registry names ("16B-offset", "32B-xor", ...).

Timing-only cells batch through ``repro_torch.core.cost_engine.cost_many``: each
workload's trace lowering is priced against *all* its architectures in one
fused device pass (``run_cells``), not one ``arch.cost`` call per cell.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core import arch as _arch
from repro_torch.core.arch import MemoryArchitecture
from repro_torch.isa.assembler import Program


@dataclass(frozen=True)
class Workload:
    """One benchmark program: functional state + optional oracle.

    ``oracle(final_memory) -> float`` returns a relative error; it certifies
    the address traces being costed are the ones a correct program emits.
    ``meta`` is merged into every record of the workload's sweep cells.
    """
    name: str
    program: Program
    init_memory: np.ndarray | None = None
    oracle: Callable[[np.ndarray], float] | None = None
    meta: dict = field(default_factory=dict)

    def trace(self):
        """The workload's dense ``AddressTrace`` (repro_torch.core.trace), built
        once and costed under every architecture of a sweep — the trace is a
        pure function of the program, so one lowering serves all cells.
        Prefer ``trace_stream`` for costing: bit-equal, O(block) memory."""
        cached = getattr(self, "_trace", None)
        if cached is None:
            cached = self.program.address_trace()
            object.__setattr__(self, "_trace", cached)
        return cached

    def trace_stream(self):
        """The workload's lazy block lowering (``repro_torch.core.trace.Trace``):
        the program streams block-by-block into the cost engine, never
        concatenating the dense (ops × 16) matrix.  The cached artifact is
        the re-iterable *block iterator*, not a dense trace — what
        ``run_cells`` prices (bit-equal to ``trace()``)."""
        cached = getattr(self, "_trace_stream", None)
        if cached is None:
            from repro_torch.isa.vm import program_trace_stream
            cached = program_trace_stream(self.program)
            object.__setattr__(self, "_trace_stream", cached)
        return cached


@dataclass(frozen=True)
class TraceWorkload:
    """A workload defined directly by its ``AddressTrace`` lowering rather
    than an ISA program — e.g. paged-KV serving traffic, whose page
    placement (and therefore address stream) depends on the architecture's
    bank map, so the trace is re-lowered per sweep cell.

    ``trace_fn(arch) -> AddressTrace``; optionally ``stream_fn(arch) ->
    repro_torch.core.trace.Trace`` (a lazy block lowering, e.g.
    ``simulate_serving_stream``) — when present, batched sweeps price the
    stream and the dense trace is never built.  Lowerings are cached — and
    batched sweeps grouped — by ``lowering_key(arch)``; the default key is
    the full ``MemSpec``, so two space points that merely share a display
    name never share a trace.  Pass a coarser key when the lowering only
    depends on part of the spec (``serving_workload`` keys on the banked
    layout, which lets every multi-port point share the canonical pool's
    stream).
    """
    name: str
    trace_fn: Callable
    meta: dict = field(default_factory=dict)
    lowering_key: Callable | None = None
    stream_fn: Callable | None = None

    def _key(self, a: MemoryArchitecture):
        return self.lowering_key(a) if self.lowering_key else a.spec

    def _cached(self, attr: str, a: MemoryArchitecture, fn: Callable):
        cache = getattr(self, attr, None)
        if cache is None:
            cache = {}
            object.__setattr__(self, attr, cache)
        key = self._key(a)
        if key not in cache:
            cache[key] = fn(a)
        return cache[key]

    def trace(self, arch):
        """The dense lowering under ``arch`` (cached per lowering key)."""
        return self._cached("_traces", _arch.resolve(arch), self.trace_fn)

    def stream(self, arch):
        """The block lowering under ``arch`` (cached per lowering key):
        ``stream_fn``'s lazy ``Trace`` when registered, else the cached
        dense trace (which the engine chunks itself).  What ``run_cells``
        and ``tune.search`` price — bit-equal to ``trace``."""
        a = _arch.resolve(arch)
        if self.stream_fn is None:
            return self.trace(a)
        return self._cached("_streams", a, self.stream_fn)


def _nan_to_blank(x: float) -> float | str:
    return "" if math.isnan(x) else x


def _record(workload, a: MemoryArchitecture, c) -> dict:
    """One tidy sweep record from a costed cell."""
    rec = {
        "workload": workload.name,
        "arch": a.name,
        "kind": a.spec.kind,
        "fmax_mhz": a.fmax_mhz,
        "load_cycles": c.load_cycles,
        "store_cycles": c.store_cycles,
        "tw_load_cycles": c.tw_load_cycles,
        "compute_cycles": c.compute_cycles,
        "total_cycles": c.total_cycles,
        "time_us": c.time_us(a.fmax_mhz),
        "fp_ops": c.fp_ops,
        "r_bank_eff": _nan_to_blank(c.read_bank_eff()),
        "w_bank_eff": _nan_to_blank(c.write_bank_eff()),
        "tw_bank_eff": _nan_to_blank(c.tw_bank_eff()),
    }
    rec.update(workload.meta)
    return rec


def run_cell(arch, workload, execute: bool = False,
             device="cuda") -> dict:
    """Cost one (architecture, workload) cell; returns a tidy record.

    Timing-only cells (the default) cost the workload's cached AddressTrace
    directly; execute=True additionally runs the program functionally.
    ``TraceWorkload`` cells re-lower the trace under the cell's architecture
    (and cannot execute — there is no program)."""
    a = _arch.resolve(arch)
    if isinstance(workload, TraceWorkload):
        if execute:
            raise ValueError(
                f"trace-only workload {workload.name!r} has no program to "
                f"execute")
        c = a.cost(workload.trace(a), device=device)
    elif execute:
        c = a.run_program(workload.program, workload.init_memory,
                          execute=True, device=device).cost
    else:
        c = a.cost(workload.trace(), device=device)
    return _record(workload, a, c)


def run_cells(archs: Iterable, workload, device="cuda") -> list[dict]:
    """Cost one workload under many architectures in as few fused passes as
    possible (one ``cost_many`` call per trace lowering).

    A ``Workload``'s trace is architecture-independent: one lowering, one
    device pass for the whole row.  A ``TraceWorkload`` groups its
    architectures by ``lowering_key`` and prices each group's shared
    lowering against all of the group's cells at once.  Both price the
    *streamed* lowering (``trace_stream`` / ``stream``) — the cached
    artifact is a re-iterable block iterator, bit-equal to the dense trace
    but O(block) in memory.  Records come back in input architecture order
    (timing-only — use ``run_cell(execute=True)`` for functional runs).
    """
    from repro_torch.core.cost_engine import cost_many
    arch_objs = [_arch.resolve(a) for a in archs]
    if isinstance(workload, TraceWorkload):
        groups: dict = {}
        for i, a in enumerate(arch_objs):
            groups.setdefault(workload._key(a), []).append(i)
        records: list = [None] * len(arch_objs)
        for idxs in groups.values():
            stream = workload.stream(arch_objs[idxs[0]])
            costs = cost_many([arch_objs[i] for i in idxs], stream,
                              device=device)
            for i, c in zip(idxs, costs):
                records[i] = _record(workload, arch_objs[i], c)
        return records
    costs = cost_many(arch_objs, workload.trace_stream(), device=device)
    return [_record(workload, a, c) for a, c in zip(arch_objs, costs)]


def sweep(archs: Iterable, workloads: Sequence[Workload] | Workload,
          execute: bool = False, device="cuda") -> list[dict]:
    """Cost every (workload × architecture) cell, workload-major (the order
    the paper's tables print in).  Timing-only sweeps price each workload's
    cached trace against all cells in one batched engine pass."""
    if isinstance(workloads, (Workload, TraceWorkload)):
        workloads = [workloads]
    archs = [_arch.resolve(a) for a in archs]
    if execute:
        return [run_cell(a, w, execute=True, device=device)
                for w in workloads for a in archs]
    return [rec for w in workloads for rec in run_cells(archs, w, device)]


def verify_workload(workload: Workload,
                    arch: MemoryArchitecture | str = "16B",
                    device="cuda") -> float:
    """Functionally execute the workload on one architecture and apply its
    oracle; returns the relative error (data movement is architecture-
    independent, so one execution certifies the whole sweep row)."""
    if workload.oracle is None:
        raise ValueError(f"workload {workload.name!r} has no oracle")
    a = _arch.resolve(arch)
    res = a.run_program(workload.program, workload.init_memory, execute=True,
                        device=device)
    return float(workload.oracle(res.memory))
