"""Autotune reproduction on the card (the counterpart of
``benchmarks/autotune.py``): ``repro_torch.tune`` re-discovers the paper's
per-workload architecture winners (the implicit conclusion of Tables
II/III: which of the 9 memories to pick for each algorithm × size).

    python -m repro_torch.bench.autotune [--smoke] [--device cuda|cpu]

For every paper workload the exhaustive search must land on the memory with
the best Table II/III wall time, and the hillclimb must agree while pricing
fewer points; the two paged-KV serving cases have the reference's
expectations.  ``--smoke`` runs the 32×32 transpose and the small serving
case only.  Pricing runs on the card unless ``--device cpu`` is given;
without a card the command fails instead of running on the host.

CSV: name,us_per_call,derived (winner | paper winner | match | cycles |
evals).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import tune
from repro_torch.bench.paper_data import TABLE2, TABLE3
from repro_torch.bench.paper_tables import format_fields
from repro_torch.bench.workloads import (fft_workload, serving_workload,
                                         transpose_workload)

TRANSPOSE_SIZES = (32, 64, 128)
FFT_RADICES = (4, 8, 16)

#: Table II excludes the VB variant (the paper doesn't run it on transpose)
TRANSPOSE_SPACE = tune.ArchSpace(multiports=("4R-1W", "4R-2W"))
FFT_SPACE = tune.PAPER_SPACE

#: serving (paged-KV) has no paper row; the expectation is the paper's
#: small-dataset conclusion — a multi-port wins raw time (4R-2W while the
#: store stream dominates, 4R-1W once gathers do and fmax decides)
SERVING_EXPECTED_SMALL = "4R-2W"
SERVING_EXPECTED_MEDIUM = "4R-1W"


def paper_winner(table: dict, time_col: int) -> str:
    return min(table, key=lambda name: table[name][time_col])


def _cases(smoke: bool, device):
    yield (transpose_workload(32), TRANSPOSE_SPACE,
           paper_winner(TABLE2[32], 3))
    yield (serving_workload(batch=4, prompt_len=16, decode_steps=8,
                            page_len=4, n_kv_layers=2, device=device),
           FFT_SPACE, SERVING_EXPECTED_SMALL)
    if smoke:
        return
    for n in TRANSPOSE_SIZES[1:]:
        yield (transpose_workload(n), TRANSPOSE_SPACE,
               paper_winner(TABLE2[n], 3))
    for radix in FFT_RADICES:
        yield (fft_workload(4096, radix), FFT_SPACE,
               paper_winner(TABLE3[radix], 4))
    yield (serving_workload(batch=8, prompt_len=64, decode_steps=64,
                            page_len=8, n_kv_layers=2, device=device),
           FFT_SPACE, SERVING_EXPECTED_MEDIUM)


def rows(smoke: bool = False, device="cuda") -> list[dict]:
    """One row per (case, strategy), each case's search priced on
    ``device``."""
    out = []
    for workload, space, paper_pick in _cases(smoke, device):
        for strategy in ("exhaustive", "hillclimb"):
            ranked = tune.search(workload=workload, space=space,
                                 strategy=strategy, device=device)
            best = ranked[0]
            out.append({
                "name": f"autotune_{workload.name}_{strategy}",
                "us_per_call": round(best.time_us, 2),
                "winner": best.arch,
                "paper_winner": paper_pick,
                "match": best.arch == paper_pick,
                "total_cycles": best.total_cycles,
                "evals": len(ranked),
            })
    return out


def main(argv=None) -> list[dict]:
    """Print the rows; returns them."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.autotune",
        description="The tuner re-discovers the paper's per-workload "
                    "winners, priced on the card.")
    ap.add_argument("--smoke", action="store_true",
                    help="the 32x32 transpose and small serving cases only")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing runs (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("autotune: no CUDA device; the search prices on "
                         "the card (pass --device cpu to run on the host)")
    out = rows(smoke=args.smoke, device=args.device)
    for r in out:
        print(format_fields(r), flush=True)
    return out


if __name__ == "__main__":
    main()
