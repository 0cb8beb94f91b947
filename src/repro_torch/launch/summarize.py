"""Render the §Dry-run / §Roofline / §Perf markdown from artifacts (port
of ``repro.launch.summarize``).

  python -m repro_torch.launch.summarize [--dir build] > summary.md

``--dir`` holds ``dryrun/`` and ``perf/`` as ``launch.dryrun`` and
``launch.perf`` write them (both under ``build/`` by default).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.roofline import load_artifacts, report

BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         "build")


def dryrun_table(artifact_dir: str) -> str:
    lines = ["| arch | shape | mesh | compile s | flops/dev | args GiB | "
             "temp GiB | coll GiB | coll ops |",
             "|---|---|---|---|---|---|---|---|---|"]
    for mesh in ("single", "multi"):
        for art in load_artifacts(artifact_dir, mesh):
            if "error" in art:
                lines.append(f"| {art['arch']} | {art['shape']} | {mesh} "
                             f"| FAILED | | | | | |")
                continue
            m = art["full"].get("memory", {})
            c = art["full"]["collectives"]
            counts = art["full"].get("collective_counts", {})
            lines.append(
                f"| {art['arch']} | {art['shape']} | {mesh} "
                f"| {art['compile_s']:.0f} "
                f"| {art['full'].get('flops', 0):.2e} "
                f"| {m.get('argument_bytes', 0)/2**30:.2f} "
                f"| {m.get('temp_bytes', 0)/2**30:.1f} "
                f"| {c.get('total', 0)/2**30:.2f} "
                f"| {sum(counts.values())} |")
    return "\n".join(lines)


def perf_table(perf_dir: str) -> str:
    if not os.path.isdir(perf_dir):
        return "(no perf artifacts)"
    rows = []
    for f in sorted(os.listdir(perf_dir)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(perf_dir, f)) as fh:
            d = json.load(fh)
        if "roofline" not in d:
            continue
        r = d["roofline"]
        var = d.get("variant", "?")
        rows.append((d["arch"], d["shape"], var, r))
    lines = ["| cell | variant | compute s | mem ub/lb s | coll s | "
             "dominant | frac pess/opt | temp GiB | fits |",
             "|---|---|---|---|---|---|---|---|---|"]
    for arch, shape, var, r in rows:
        lines.append(
            f"| {arch} × {shape} | {var} | {r['compute_s']:.3f} "
            f"| {r['memory_s']:.2f}/{r['memory_lb_s']:.2f} "
            f"| {r['collective_s']:.3f} | {r['dominant']} "
            f"| {r['roofline_fraction']:.3f}/{r['roofline_fraction_opt']:.3f} "
            f"| {r['temp_gib']:.1f} | {'Y' if r['fits_hbm'] else 'N'} |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.summarize")
    ap.add_argument("--dir", default=os.path.normpath(BUILD_DIR))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="accepted for the port's common flags; the "
                         "summary reads artifacts only")
    args = ap.parse_args(argv)
    dd = os.path.join(args.dir, "dryrun")
    pd = os.path.join(args.dir, "perf")
    print("## §Dry-run grid\n")
    print(dryrun_table(dd))
    print("\n## §Roofline (single-pod)\n")
    print(report(dd, "single"))
    print("\n## §Roofline (multi-pod)\n")
    print(report(dd, "multi"))
    print("\n## §Perf variants\n")
    print(perf_table(pd))


if __name__ == "__main__":
    main()
