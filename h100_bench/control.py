"""The two readings a cell's ``max_logit_gap`` limit is set from, on the
chip at the cell's own size: for each seed, one run of the cell with a
short window, then the same finished requests replayed through the
float32 reference twice, judging the program's served tokens (the lower
reading) and the fp8 control's own first choices at the same positions
(the upper reading).  The benchmark's own runs never run the control.

    python3 h100_bench/control.py --workload <name> --seconds 5 \
        --seeds 11 12 13 ...

Prints one JSON line per seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from h100_bench import harness, traffic
    bench = harness.benchmark()
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg_json = json.loads((ROOT / cfg_entry["file"]).read_text())
    mix = traffic.load_mix(wl["traffic"])
    limits = harness.load_json("limits", f"{wl['name']}.json")
    for seed in args.seeds:
        rec = harness.run_cell(cfg_json, mix, limits, seed, args.seconds,
                               False, time.perf_counter(), control=True)
        print(json.dumps({
            "workload": wl["name"], "seed": seed,
            "program_gap": rec["checks"]["max_logit_gap"]["value"],
            "control_gap": rec["control_gap"],
            "checked_tokens": rec["checks"]["checked_tokens"]["value"],
            "checked_requests": rec["checked_requests"],
            "check_s": rec["check_s"],
            "program_gaps": rec["program_gaps"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
