"""Beyond-paper memory-architecture variants on the paper's own
benchmarks, priced on the card (the counterpart of
``benchmarks/beyond_paper.py``):

  * XOR-folded bank map — bank = (addr ^ (addr >> log2 B)) & (B-1):
    de-conflicts the power-of-two strides of Cooley-Tukey passes that
    defeat both the LSB and Offset maps.
  * Broadcast coalescing — a bank serves one *address* per cycle to every
    requesting lane (commercial-GPU shared-memory semantics): collapses the
    paper's ~6-9 %-efficient twiddle loads.

    python -m repro_torch.bench.beyond_paper [--device cuda|cpu]

The variants resolve by name through ``repro_torch.core.arch.get``
("16B-xor-bcast" etc.), and ``sweep`` prices them on the card unless
``--device cpu`` is given.

CSV: name,us_per_call,derived.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.bench.paper_data import TABLE3
from repro_torch.bench.paper_tables import format_fields
from repro_torch.bench.runner import sweep
from repro_torch.bench.workloads import fft_workload, transpose_workload

VARIANTS = ("16B-offset", "16B-offset-bcast", "16B-xor", "16B-xor-bcast")

#: best cycle count anywhere in each Table III radix row (incl. multi-port)
PAPER_BEST = {4: 53267, 8: 44300, 16: 37214}


def rows(device="cuda") -> list[dict]:
    out = []
    for rec in sweep(VARIANTS, [fft_workload(4096, r) for r in (4, 8, 16)],
                     device=device):
        radix, total = rec["radix"], rec["total_cycles"]
        base = TABLE3[radix]["16B-offset"][3]
        out.append({
            "name": f"beyond_fft r{radix}_{rec['arch']}",
            "us_per_call": round(rec["time_us"], 2),
            "total": total,
            "vs_paper_16B_offset_pct": round(100 * (total - base) / base, 1),
            "vs_paper_best_any_pct":
                round(100 * (total - PAPER_BEST[radix]) / PAPER_BEST[radix],
                      1),
            "fp_efficiency_pct": round(100 * rec["fp_ops"] / total, 1),
        })
    for rec in sweep(VARIANTS, [transpose_workload(n) for n in (32, 128)],
                     device=device):
        out.append({
            "name": f"beyond_transpose{rec['n']}_{rec['arch']}",
            "us_per_call": round(rec["time_us"], 2),
            "total": rec["total_cycles"],
            "load": rec["load_cycles"], "store": rec["store_cycles"],
        })
    return out


def main(argv=None) -> list[dict]:
    """Print the rows; returns them."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.beyond_paper",
        description="XOR maps and broadcast coalescing on the paper's "
                    "benchmarks, priced on the card.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing runs (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("beyond_paper: no CUDA device; the sweep prices on "
                         "the card (pass --device cpu to run on the host)")
    out = rows(args.device)
    for r in out:
        print(format_fields(r), flush=True)
    return out


if __name__ == "__main__":
    main()
