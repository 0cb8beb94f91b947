"""Benchmark driver (port of ``benchmarks/run.py``): one section per paper
table/figure and harness, in the reference's order, each after its
``# --- name ---`` line.  Prints ``name,us_per_call,derived`` CSV.

  python -m repro_torch.bench.run [section ...] [--device cpu]

  table2    — Table II   (transpose × 8 memories × 3 sizes)
  table3    — Table III  (FFT radix 4/8/16 × 9 memories, func-verified)
  table1    — Table I    (area model / sector footprints)
  fig9      — Fig 9      (cost vs performance crossover)
  autotune  — the tuner re-derives the paper's per-workload winners
  serving   — paged-KV serving traffic × 9 memories
  cost      — batched cost engine vs per-arch loop (writes
              build/cost_bench.json)
  beyond    — the beyond-paper sweeps
  bankscale — bank-count scaling
  kernels   — the kernel micro-bench
  roofline  — §Roofline terms from the dry run's artifacts (if present)

Each section runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

SECTIONS = ("table2", "table3", "table1", "fig9", "autotune", "serving",
            "cost", "beyond", "bankscale", "kernels", "roofline")


def _section(name: str, device: str) -> None:
    """Run one section's ``main`` with an explicit argument list (never
    this driver's own ``sys.argv``)."""
    from repro_torch.bench import (autotune, bank_scaling, beyond_paper,
                                   cost_bench, kernel_bench, paper_tables,
                                   roofline_report, serving_bench)
    flags = ["--device", device]
    if name in ("table2", "table3", "table1", "fig9"):
        paper_tables.main([name, *flags])
        return
    {"autotune": autotune, "serving": serving_bench, "cost": cost_bench,
     "beyond": beyond_paper, "bankscale": bank_scaling,
     "kernels": kernel_bench, "roofline": roofline_report}[name].main(flags)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run")
    ap.add_argument("sections", nargs="*", metavar="section",
                    help=f"any of {', '.join(SECTIONS)} (default: all, in "
                         "this order)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every section runs (default: the card)")
    args = ap.parse_args(argv)
    unknown = sorted(set(args.sections) - set(SECTIONS))
    if unknown:
        ap.error(f"unknown sections {unknown}; choose from {list(SECTIONS)}")
    for s in args.sections or SECTIONS:
        print(f"# --- {s} ---", flush=True)
        _section(s, args.device)


if __name__ == "__main__":
    main()
