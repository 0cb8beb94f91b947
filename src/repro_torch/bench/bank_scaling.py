"""Bank-count scaling study on the card (the counterpart of
``benchmarks/bank_scaling.py``, beyond the paper's 4/8/16 banks): how far
does "more banks mean more absolute performance" (paper §VI) hold for the
radix-16 FFT, and when does the crossbar area stop paying for itself?

    python -m repro_torch.bench.bank_scaling [--device cuda|cpu]

The conflict model works for any power-of-two bank count; area beyond 16
banks is extrapolated from Table I's observed linear arbiter/mux scaling
(16 banks = 1 sector, each doubling about doubles the arbitration logic).
The names ("32B-xor" etc.) resolve through ``repro_torch.core.arch.get``,
and ``sweep`` prices them on the card unless ``--device cpu`` is given.

CSV: name,us_per_call,derived.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bench.paper_tables import format_fields
from repro_torch.bench.runner import sweep
from repro_torch.bench.workloads import fft_workload

BANKS = (4, 8, 16, 32, 64)
MAPPINGS = ("offset", "xor")


def _area_sectors(n_banks: int) -> float:
    """Table I observed: 16 banks = 1 sector, halving per halving; linear
    extrapolation above 16 (arbiters + muxes dominate and scale about
    linearly)."""
    return n_banks / 16.0


def rows(device="cuda") -> list[dict]:
    archs = [f"{nb}B-{mapping}" for nb in BANKS for mapping in MAPPINGS]
    out = []
    for rec in sweep(archs, fft_workload(4096, 16), device=device):
        nb = int(rec["arch"].split("B-")[0])
        t = rec["time_us"]
        area = _area_sectors(nb)
        out.append({
            "name": f"bankscale_fft_r16_{rec['arch'].replace('-', '_')}",
            "us_per_call": round(t, 2),
            "total_cycles": rec["total_cycles"],
            "area_sectors": area,
            "perf_per_area": round(1.0 / (t * area), 4),
            "d_bank_eff_pct": round(rec["r_bank_eff"], 1),
        })
    return out


def main(argv=None) -> list[dict]:
    """Print the rows; returns them."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.bank_scaling",
        description="The radix-16 FFT on 4 to 64 banks, priced on the "
                    "card.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing runs (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bank_scaling: no CUDA device; the sweep prices on "
                         "the card (pass --device cpu to run on the host)")
    out = rows(args.device)
    for r in out:
        print(format_fields(r), flush=True)
    return out


if __name__ == "__main__":
    main()
