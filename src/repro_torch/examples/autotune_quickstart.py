"""Pick the right memory architecture for a workload, priced on the card
(the counterpart of ``examples/autotune_quickstart.py``).

Run:  PYTHONPATH=src python -m repro_torch.examples.autotune_quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import tune
from repro_torch.bench.workloads import fft_workload, transpose_workload


def main(argv=None) -> dict:
    """Run the four searches and print their winners; returns them."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.autotune_quickstart",
        description="Four architecture searches, priced on the card.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing runs (default: cuda)")
    device = ap.parse_args(argv).device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("autotune_quickstart: no CUDA device; the search "
                         "prices on the card (pass --device cpu to run on "
                         "the host)")
    out = {}

    # 1. Exhaustive search over the paper's memories (Table II's implicit
    #    conclusion): which memory should you build for a 64x64 transpose?
    ranked = tune.search(workload=transpose_workload(64),
                         space=tune.ArchSpace(multiports=("4R-1W", "4R-2W")),
                         device=device)
    print("transpose64 ranking (best first):")
    for r in ranked[:3]:
        print(f"  {r.arch:12s} {r.total_cycles:6d} cyc  {r.time_us:6.2f} us")
    out["transpose64"] = ranked[0].arch

    # 2. Hillclimb the beyond-paper grid (4..32 banks x 4 maps x broadcast)
    #    for the radix-4 FFT -- fewer evaluations than the whole grid.
    climbed = tune.search(workload=fft_workload(4096, 4),
                          space=tune.EXTENDED_SPACE, strategy="hillclimb",
                          device=device)
    print(f"\nfft4096r4 hillclimb winner: {climbed[0].arch} "
          f"({climbed[0].time_us:.1f} us, {len(climbed)} of "
          f"{len(tune.EXTENDED_SPACE.names())} points evaluated)")
    out["fft4096r4_hillclimb"] = (climbed[0].arch, len(climbed))

    # 3. Any registry kernel with a `trace` generator is tunable: a
    #    same-address gather stream (16-way serialization) wants broadcast
    #    coalescing.
    table = np.zeros((256, 64), np.float32)
    hot_idx = np.zeros(512, np.int64)               # every lane hits row 0
    ranked = tune.search("banked_gather", (table, hot_idx),
                         space=tune.EXTENDED_SPACE, device=device)
    print(f"\nhot-row gather winner: {ranked[0].arch} "
          f"({ranked[0].total_cycles} cyc vs {ranked[-1].total_cycles} "
          f"worst)")
    out["hot_gather"] = ranked[0].arch

    # 4. The Fig 9 question -- cheapest architecture that still FITS at
    #    224 KB (multi-port replication stops fitting a sector):
    ranked = tune.search(workload=fft_workload(4096, 16),
                         objective="area_time", capacity_kb=224.0,
                         device=device)
    feasible = [r for r in ranked if r.objective < float("inf")]
    print(f"\n224KB area x time winner: {feasible[0].arch} "
          f"({len(ranked) - len(feasible)} architectures over capacity)")
    out["area_time_224kb"] = feasible[0].arch
    return out


if __name__ == "__main__":
    main()
