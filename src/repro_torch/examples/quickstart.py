"""Quickstart: the paper in 60 seconds, through the three-layer API, on the
card (the counterpart of ``examples/quickstart.py``).

1. Layer 1 — ``repro_torch.core.arch``: pick memory architectures by name
   and show bank-conflict arbitration on the paper's Fig-4 example.
2. Layer 3 — ``repro_torch.bench``: sweep the 32×32 transpose benchmark
   across architectures and print the Table-II-style cycle breakdown.
3. Layer 2 — ``repro_torch.kernels``: dispatch the banked-gather kernel
   (the hand-written CUDA ``gather_rows`` on the card) and the MoE-dispatch
   arbiter math under an architecture, uniformly.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import kernels
from repro_torch.bench import sweep, transpose_workload
from repro_torch.core import arch
from repro_torch.core import (arbitrate_schedule, bank_counts,
                              banked_dispatch, serialization_factor)


def main(argv=None) -> dict:
    """Print the three sections; returns what they printed, and section
    3's gather inputs and result (``gather``: table, indices, rows)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart",
        description="The paper in 60 seconds: arbitration, a transpose "
                    "sweep, and the kernels under an architecture.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the tensors, the pricing and the gather "
                         "run (default: cuda)")
    device = ap.parse_args(argv).device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quickstart: no CUDA device; the quickstart runs "
                         "on the card (pass --device cpu to run on the "
                         "host)")
    out = {}

    print("=" * 64)
    print("1) Architectures by name + carry-chain arbitration "
          "(paper Fig. 4/6)")
    mem = arch.get("8B")     # any of the paper's 9 names, or e.g. "32B-xor"
    banks = torch.tensor([0, 1, 1, 3, 1, 4, 3, 6], dtype=torch.int32,
                         device=device)
    schedule, cycles = arbitrate_schedule(banks, mem.n_banks)
    print(f"   {mem!r}  lane->bank {banks.tolist()}  per-bank load "
          f"{bank_counts(banks, mem.n_banks).tolist()}")
    print(f"   max conflicts = {int(cycles)} cycles (bank 1: lanes 1,2,4)")
    grants = []
    for c in range(int(cycles)):
        served = [(b, int(schedule[c, b].argmax()))
                  for b in range(mem.n_banks) if schedule[c, b].sum() > 0]
        grants.append(served)
        print(f"   cycle {c}: bank<-lane grants {served}")
    out["arbitration"] = {"cycles": int(cycles), "grants": grants}

    print("=" * 64)
    print("2) 32x32 transpose sweep: banked (16B, offset/lsb) vs 4R-2W")
    recs = sweep(["16B-offset", "16B", "4R-2W"], transpose_workload(32),
                 device=device)
    for r in recs:
        print(f"   {r['arch']:12s} load={r['load_cycles']:5d} "
              f"store={r['store_cycles']:5d} total={r['total_cycles']:5d}  "
              f"time={r['time_us']:5.2f}us @ {r['fmax_mhz']:.0f} MHz")
    out["transpose32"] = recs

    print("=" * 64)
    print("3) Kernels dispatch uniformly under any architecture")
    table = torch.arange(64 * 512, dtype=torch.float32,
                         device=device).reshape(64, 512)
    # the row kernels take int64 row indices
    idx = torch.tensor([3, 60, 7, 7], dtype=torch.int64, device=device)
    gather = kernels.get("banked_gather")
    mem = arch.get("16B-offset")
    rows = gather.run(mem, table, idx)
    cost = gather.cost_cycles(mem, table, idx, device=device)
    print(f"   banked_gather({idx.tolist()}) -> rows {rows[:, 0].tolist()}  "
          f"(cost {cost} cyc)")
    out["gather"] = (table, idx, rows)
    out["gather_cost"] = cost

    expert_of_token = torch.tensor([3, 1, 3, 3, 0, 1, 3, 2],
                                   dtype=torch.int32, device=device)
    plan = banked_dispatch(expert_of_token, n_banks=4, capacity=2)
    factor = float(serialization_factor(plan))
    print("   the same arbiter as MoE dispatch (experts = banks):")
    print(f"   expert ids    : {plan.bank.tolist()}")
    print(f"   grant position: {plan.position.tolist()}")
    print(f"   kept (cap=2)  : {plan.kept.tolist()}  "
          f"(expert 3 oversubscribed -> drop latest arrivals)")
    print(f"   serialization factor (max/mean load): {factor:.2f}")
    out["dispatch"] = {"bank": plan.bank.tolist(),
                       "position": plan.position.tolist(),
                       "kept": plan.kept.tolist(), "factor": factor}
    return out


if __name__ == "__main__":
    main()
