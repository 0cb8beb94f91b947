"""§Roofline harness: reads the dry run's artifacts and prints the
three-term table (port of ``benchmarks/roofline_report.py``).  CSV:
name,us_per_call(dominant term in us),derived.

  python -m repro_torch.bench.roofline_report [--dir build/dryrun]

Without artifacts it prints no rows.  The row key ``fits_80g`` (the
reference's ``fits_16g``) says whether arguments and temporaries fit the
H100's 80 GB.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import SHAPES
from repro_torch.launch.roofline import cell_roofline, load_artifacts

ART = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                   "dryrun")


def rows(mesh: str = "single", art_dir: str = ART) -> list[dict]:
    out = []
    if not os.path.isdir(art_dir):
        return out
    for art in load_artifacts(art_dir, mesh):
        r = cell_roofline(art)
        if r is None:
            out.append({"name": f"roofline_{art['arch']}_{art['shape']}",
                        "us_per_call": -1, "error": True})
            continue
        row = {
            "name": f"roofline_{r.arch}_{r.shape}",
            "us_per_call": round(r.dominant_s * 1e6, 1),
            "compute_s": round(r.compute_s, 5),
            "memory_s": round(r.memory_s, 5),
            "memory_lb_s": round(r.memory_lb_s, 5),
            "collective_s": round(r.collective_s, 5),
            "dominant": r.dominant,
            "useful_ratio": round(r.useful_ratio, 3),
            "roofline_fraction": round(r.roofline_fraction, 3),
            "roofline_fraction_opt": round(r.roofline_fraction_opt, 3),
            "fits_80g": r.fits_hbm,
        }
        shape = SHAPES[r.shape]
        tps = r.decode_tokens_per_s(shape)
        if tps is not None:
            row["decode_tokens_per_s"] = round(tps, 1)
            row["decode_latency_ms"] = round(r.decode_latency_ms(shape), 2)
        out.append(row)
    return out


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.roofline_report")
    ap.add_argument("--dir", default=os.path.normpath(ART),
                    help="the dry run's artifacts")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="accepted for the port's common flags; the "
                         "report reads artifacts only")
    args = ap.parse_args(argv)
    out = rows(art_dir=args.dir)
    for r in out:
        extra = "|".join(f"{k}={v}" for k, v in r.items()
                         if k not in ("name", "us_per_call"))
        print(f"{r['name']},{r['us_per_call']},{extra}")
    return out


if __name__ == "__main__":
    main()
