"""The paper's Tables I, II and III and Fig 9 on the card: the counterpart
of ``benchmarks/table1_area.py``, ``benchmarks/table2_transpose.py``,
``benchmarks/table3_fft.py``, ``benchmarks/fig9_cost_perf.py`` and
``examples/fft_on_banked_memory.py``.

    python -m repro_torch.bench.paper_tables [table1] [table2] [table3] [fig9] [--device cuda|cpu]

With no section it prints Tables II and III.  For each of their workloads
it (1) builds the ISA program and runs it functionally on the SIMT VM
(host numpy: the VM is the simulated processor), (2) prices every
(architecture × workload) cell through ``sweep`` on ``device`` and (3)
runs the workload's data computation through the kernel registry on
``device`` — ``banked_transpose`` on the N×N input of the memory image,
``fft_stage`` (one 6-pass radix-4 transform) on the 4096-point input — and
reports its relative error against the workload's oracle as
``kernel_err``.  Table I is the area model's host arithmetic
(``repro_torch.core.cost``); Fig 9 prices ``fft4096r16`` on its six
memories through ``sweep`` on ``device`` and sets each time beside the
whole processor's footprint at 64, 112, 168 and 224 KB.  The device is the
card unless ``--device cpu`` is given; without a card the command fails
instead of running on the host.

CSV: name,us_per_call,derived (for Tables II/III: sim cycles | paper
cycles | Δ% | efficiencies | errors; for Table I and Fig 9 the reference
scripts' ``key=value`` fields), as the JAX scripts print it.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.bench.paper_data import TABLE2, TABLE3
from repro_torch.bench.runner import Workload, sweep, verify_workload
from repro_torch.bench.workloads import fft_workload, transpose_workload
from repro_torch.core import arch
from repro_torch.core import cost as C
from repro_torch.core.arch import (PAPER_ARCHITECTURES,
                                   TRANSPOSE_ARCHITECTURES)
from repro_torch.core.memsim import banked, multiport
from repro_torch.isa.programs.fft import oracle_spectrum

SIZES = (32, 64, 128)
RADICES = (4, 8, 16)
FFT_N = 4096
#: Table I's memories (``benchmarks/table1_area.py``)
TABLE1_MEMS = (banked(16), banked(8), banked(4), multiport(4, 1),
               multiport(4, 2))
#: Fig 9's capacities and memories (``benchmarks/fig9_cost_perf.py``)
FIG9_SIZES_KB = (64, 112, 168, 224)
FIG9_ARCHS = ("4R-1W", "4R-2W", "16B-offset", "16B", "8B-offset",
              "4B-offset")
#: the memory the functional runs use (data movement is architecture-
#: independent, so one run certifies a whole row, as in the reference)
VERIFY_ARCH = "16B"


def transpose_kernel_err(workload: Workload, device) -> float:
    """``banked_transpose`` on the workload's N×N input on ``device``,
    judged by the workload's own oracle on the resulting memory image."""
    n = workload.meta["n"]
    x = workload.init_memory[:n * n].reshape(n, n)
    y = kernels.get("banked_transpose").run(
        VERIFY_ARCH, torch.from_numpy(x).to(device))
    memory = np.concatenate([x.reshape(-1), y.cpu().numpy().reshape(-1)])
    return workload.oracle(memory)


def fft_kernel_err(workload: Workload, device) -> float:
    """One radix-4 ``fft_stage`` transform of the workload's 4096-point
    input on ``device``, relative max error against ``oracle_spectrum(x,
    4)`` (the radix-4 digit-reversed order)."""
    n, mem = workload.meta["n"], workload.init_memory
    x = (mem[0:2 * n:2] + 1j * mem[1:2 * n:2]).astype(np.complex64)
    got = kernels.get("fft_stage").run(
        VERIFY_ARCH, torch.from_numpy(x[None]).to(device))[0].cpu().numpy()
    want = oracle_spectrum(x, 4)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def table2_rows(device="cuda") -> list[dict]:
    """Table II: the transpose over the 8 memories × N ∈ SIZES, priced on
    ``device``, each row with its workload's ``kernel_err``."""
    workloads = [transpose_workload(n) for n in SIZES]
    kernel_err = {w.meta["n"]: transpose_kernel_err(w, device)
                  for w in workloads}
    out = []
    for rec in sweep(TRANSPOSE_ARCHITECTURES, workloads, device=device):
        n, name = rec["n"], rec["arch"]
        ref = TABLE2[n].get(name)
        delta = (100 * (rec["total_cycles"] - ref[2]) / ref[2]
                 if ref else None)
        banked = rec["kind"] == "banked"
        out.append({
            "name": f"transpose{n}_{name}",
            "us_per_call": round(rec["time_us"], 3),
            "load": rec["load_cycles"], "store": rec["store_cycles"],
            "total": rec["total_cycles"],
            "paper_total": ref[2] if ref else "",
            "delta_pct": round(delta, 2) if delta is not None else "",
            "r_bank_eff": round(rec["r_bank_eff"], 1) if banked else "",
            "w_bank_eff": round(rec["w_bank_eff"], 1) if banked else "",
            "kernel_err": kernel_err[n],
        })
    return out


def table3_rows(device="cuda", verify: bool = True) -> list[dict]:
    """Table III: the 4096-point FFT over the 9 memories × radix ∈ RADICES,
    priced on ``device``; ``verify`` runs each program on the VM
    (``func_rel_err``) and the radix-4 kernel transform (``kernel_err``)."""
    workloads = [fft_workload(FFT_N, radix) for radix in RADICES]
    func_err = {w.meta["radix"]: (verify_workload(w, VERIFY_ARCH, device)
                                  if verify else None)
                for w in workloads}
    kernel_err = {w.meta["radix"]: (fft_kernel_err(w, device) if verify
                                    else None)
                  for w in workloads}
    out = []
    for rec in sweep(PAPER_ARCHITECTURES, workloads, device=device):
        radix, name = rec["radix"], rec["arch"]
        ref = TABLE3[radix].get(name)
        delta = (100 * (rec["total_cycles"] - ref[3]) / ref[3]
                 if ref else None)
        eff = 100.0 * rec["fp_ops"] / max(rec["total_cycles"], 1)
        out.append({
            "name": f"fft4096r{radix}_{name}",
            "us_per_call": round(rec["time_us"], 2),
            "D": rec["load_cycles"], "TW": rec["tw_load_cycles"],
            "S": rec["store_cycles"], "total": rec["total_cycles"],
            "paper_total": ref[3] if ref else "",
            "delta_pct": round(delta, 2) if delta is not None else "",
            "efficiency_pct": round(eff, 1),
            "paper_eff": ref[5] if ref else "",
            "func_rel_err": func_err[radix],
            "kernel_err": kernel_err[radix],
        })
    return out


def table1_rows() -> list[dict]:
    """Table I / §IV: the SIMT core's resources, then each memory's
    resources, largest logical capacity, footprints and replication."""
    core = C.core_resources()
    out = [{"name": "simt_core_16sp", "us_per_call": 0,
            "alms": core.alms, "m20k": core.m20k, "dsp": core.dsp}]
    for spec in TABLE1_MEMS:
        r = C.memory_resources(spec)
        cap = C.max_capacity_kb(spec)
        out.append({
            "name": f"mem_{spec.name}",
            "us_per_call": 0,
            "alms": r.alms, "m20k": r.m20k,
            "max_capacity_kb": cap,
            "footprint_64kb": round(C.footprint_alms(spec, 64.0)),
            "footprint_max": round(C.footprint_alms(spec, cap)),
            "replication": C.replication_factor(spec),
        })
    return out


def fig9_rows(device="cuda") -> list[dict]:
    """Fig 9: the radix-16 4096-point FFT priced on ``device`` on six
    memories, each time beside the whole processor's footprint at each
    capacity ("over-capacity" where the replicated data does not fit)."""
    perf = {rec["arch"]: rec["time_us"]
            for rec in sweep(FIG9_ARCHS, fft_workload(FFT_N, 16),
                             device=device)}
    slowest = max(perf.values())
    out = []
    for size in FIG9_SIZES_KB:
        for name in FIG9_ARCHS:
            try:
                area = arch.get(name).processor_footprint_alms(float(size))
            except ValueError:
                out.append({"name": f"fig9_{size}KB_{name}",
                            "us_per_call": perf[name],
                            "footprint_alms": "over-capacity",
                            "norm_perf": round(perf[name] / slowest, 3)})
                continue
            out.append({"name": f"fig9_{size}KB_{name}",
                        "us_per_call": perf[name],
                        "footprint_alms": round(area),
                        "norm_perf": round(perf[name] / slowest, 3),
                        "perf_per_area": round(1e6 / (perf[name] * area), 2)})
    return out


def format_fields(r: dict) -> str:
    """A row as the reference scripts print it: name, us_per_call, then
    every other field as ``key=value`` joined by ``|``."""
    extra = "|".join(f"{k}={v}" for k, v in r.items()
                     if k not in ("name", "us_per_call"))
    return f"{r['name']},{r['us_per_call']},{extra}"


def format_row(table: str, r: dict) -> str:
    """One CSV line, as the JAX scripts print it, plus ``kernel_err`` for
    Tables II and III."""
    if table in ("table1", "fig9"):
        return format_fields(r)
    if table == "table2":
        derived = (f"total={r['total']}|paper={r['paper_total']}|"
                   f"d={r['delta_pct']}%|Reff={r['r_bank_eff']}|"
                   f"Weff={r['w_bank_eff']}")
    else:
        derived = (f"total={r['total']}|paper={r['paper_total']}|"
                   f"d={r['delta_pct']}%|eff={r['efficiency_pct']}%"
                   f"|paper_eff={r['paper_eff']}%"
                   f"|func_err={r['func_rel_err']}")
    return (f"{r['name']},{r['us_per_call']},{derived}"
            f"|kernel_err={r['kernel_err']}")


TABLES = {"table1": lambda device: table1_rows(), "table2": table2_rows,
          "table3": table3_rows, "fig9": fig9_rows}
#: the sections printed when none is named
DEFAULT_TABLES = ("table2", "table3")


def main(argv=None) -> dict:
    """Print the requested tables; returns their rows by table name."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.paper_tables",
        description="The paper's Tables I, II and III and Fig 9 priced on "
                    "the card.")
    ap.add_argument("tables", nargs="*",
                    help="table1, table2, table3 and/or fig9 (default: "
                         "table2 and table3)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing and kernels run (default: cuda)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.tables) - set(TABLES))
    if unknown:
        ap.error(f"unknown tables {unknown}; choose from {list(TABLES)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("paper_tables: no CUDA device; the tables run on "
                         "the card (pass --device cpu to run on the host)")
    out = {}
    for table in args.tables or DEFAULT_TABLES:
        out[table] = TABLES[table](args.device)
        for r in out[table]:
            print(format_row(table, r), flush=True)
    return out


if __name__ == "__main__":
    main()
