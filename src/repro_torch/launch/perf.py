"""§Perf hillclimb driver: re-trace a cell under RunConfig variants and
record the roofline-term deltas (port of ``repro.launch.perf``).

Each variant is one *named* change against the cell's baseline RunConfig;
results land in ``build/perf/<arch>__<shape>__<variant>.json`` unless
``--out`` names another place.

Usage:
  python -m repro_torch.launch.perf --arch phi3.5-moe-42b-a6.6b \
      --shape train_4k --variant moe_scatter='{"moe_impl":"scatter"}'
  python -m repro_torch.launch.perf --arch mixtral-8x22b --shape train_4k \
      --suite moe
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.roofline import cell_roofline

PERF_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "build", "perf")

#: Named iteration suites per bottleneck family (the reference's candidate
#: changes, variant for variant).
SUITES = {
    # Cell A: mixtral-8x22b train_4k
    "moe": {
        "legacy_shard": {"moe_legacy_shard": True},   # A0 paper-naive baseline
        "baseline": {},                               # A1 data-sharded groups
        "moe_scatter": {"moe_impl": "scatter"},       # A2 index dispatch
        "micro4": {"microbatches": 4},                # A3 (predicted worse)
        "seq_parallel": {"seq_parallel": True},       # A4
        "moe_a2a": {"moe_impl": "a2a"},               # A5 expert-parallel a2a
                                                      # (needs E % tp == 0)
    },
    # Cell B: qwen1.5-110b train_4k
    "dense_train": {
        "baseline": {},
        "ce_dense": {"ce_impl": "dense"},             # B0 naive-CE baseline
        "micro4": {"microbatches": 4},                # B1a
        "micro16": {"microbatches": 16},              # B1b
        "seq_parallel": {"seq_parallel": True},       # B2
        "sp_micro4": {"seq_parallel": True, "microbatches": 4},  # B3
        "remat_dots": {"remat": "dots"},              # B4 (worse memory)
    },
    # Cell C: falcon-mamba-7b prefill_32k
    "inference": {
        "baseline": {},
        "no_fsdp": {"fsdp_axis": ""},                 # C1 replicate weights
        "seq_parallel": {"seq_parallel": True},       # C2 RS+AG residuals
        "sp_no_fsdp": {"seq_parallel": True, "fsdp_axis": ""},   # C3
    },
}


def run_variant(arch: str, shape_name: str, variant: str, overrides: dict,
                out_dir: str, multi_pod: bool = False,
                device: str = "cuda") -> dict:
    shape = SHAPES[shape_name]
    res = lower_cell(arch, shape, multi_pod, overrides or None,
                     verbose=False, device=device)
    res["variant"] = variant
    res["overrides"] = overrides
    r = cell_roofline(res)
    if r is not None:
        res["roofline"] = {
            "compute_s": r.compute_s, "memory_s": r.memory_s,
            "memory_lb_s": r.memory_lb_s,
            "collective_s": r.collective_s, "dominant": r.dominant,
            "useful_ratio": r.useful_ratio,
            "roofline_fraction": r.roofline_fraction,
            "roofline_fraction_opt": r.roofline_fraction_opt,
            "temp_gib": r.temp_gib, "fits_hbm": r.fits_hbm,
        }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{variant}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    rf = res.get("roofline", {})
    print(f"[{arch} × {shape_name} × {variant}] "
          f"compute={rf.get('compute_s', 0):.4f}s "
          f"mem={rf.get('memory_s', 0):.4f}s "
          f"coll={rf.get('collective_s', 0):.4f}s "
          f"dom={rf.get('dominant')} "
          f"frac={rf.get('roofline_fraction', 0):.3f} "
          f"temp={rf.get('temp_gib', 0):.1f}GiB")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.perf")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--suite", choices=list(SUITES))
    ap.add_argument("--variant", action="append", default=[],
                    help="name='{json overrides}'")
    ap.add_argument("--out", default=os.path.normpath(PERF_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the dry run's fake tensors")
    args = ap.parse_args(argv)

    variants: dict = {}
    if args.suite:
        variants.update(SUITES[args.suite])
    for v in args.variant:
        name, _, js = v.partition("=")
        variants[name] = json.loads(js) if js else {}

    failures = 0
    for name, overrides in variants.items():
        path = os.path.join(args.out,
                            f"{args.arch}__{args.shape}__{name}.json")
        if args.skip_existing and os.path.exists(path):
            print("skip", path)
            continue
        try:
            run_variant(args.arch, args.shape, name, overrides, args.out,
                        device=args.device)
        except Exception as e:
            failures += 1
            print(f"FAILED {name}: {e!r}")
    if failures:
        raise SystemExit(f"{failures} variants failed")


if __name__ == "__main__":
    main()
