"""Whole-model decode traffic priced on every paper memory, on the card (the
counterpart of ``benchmarks/model_traffic_bench.py``): which memory
architecture serves a whole Llama-style decode step, not one kernel at a
time.

    python -m repro_torch.bench.model_traffic_bench [--smoke] [--check]
        [--device cuda|cpu] [--out PATH]

Two sections:

  * ``model_*`` rows — one decode step of each model config
    (llama3_2_1b / mixtral_8x22b / jamba_v0_1_52b, their published full
    configs) lowered by ``repro_torch.models.model_step_trace``: attention
    QKV/O rows + RoPE gather + paged-KV page gathers, MoE all-to-all
    dispatch through the carry-chain arbiter, and SSM stride-N state
    updates, stitched per the config's layer pattern into one streamed
    ``Trace`` and priced per architecture (the KV page allocator follows
    the arch's bank map);
  * the headline ranking — ``tune.search`` over the nine paper memories on
    each whole step against the per-kernel winners of ``attn_decode`` /
    ``moe_a2a`` / ``ssm_scan`` in isolation: does whole-application
    traffic flip the microkernel verdict?

CSV: name,us_per_call,derived.  ``--smoke`` runs llama3_2_1b only.
``--check`` also runs the gates and exits non-zero if one fails:

  * the pinned headline: the llama3_2_1b whole-step winner (16B), the
    ``attn_decode`` kernel winner (4R-1W), and the flip between them;
  * O(block) streaming: a whole mixtral_8x22b step (~109k ops) priced
    through the stream with a host peak (``tracemalloc``'s, plus the cost
    engine's staging buffers, which torch allocates and ``tracemalloc``
    does not see) at most half the dense (ops × 16) int32 matrix it never
    builds.

Pricing runs on the card unless ``--device cpu`` is given (without a card
the command fails instead of running on the host).  The JSON goes to
``--out`` (default ``build/model_traffic_bench.json`` in the checkout),
with the card's name and power limit; the reference's ``BENCH_cost.json``
is never written.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import tracemalloc
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench import model_workload, sweep
from repro_torch.bench.cost_bench import card_name_and_power
from repro_torch.core.arch import PAPER_ARCHITECTURES

OUT_JSON = (Path(__file__).resolve().parents[3] / "build"
            / "model_traffic_bench.json")

CONFIGS = ("llama3_2_1b", "mixtral_8x22b", "jamba_v0_1_52b")
BATCH, PROMPT_LEN, PAGE_LEN = 4, 32, 8
BLOCK_OPS = 4096

#: canonical per-kernel tune points (the reference analysis CLI's check
#: points): a paged KV table with unmapped tails, mid-page and
#: page-boundary positions; a seeded 64-request routing over 8 experts;
#: one SSM layer of 2 × 64 channels with a 16-word state
KERNEL_POINTS = {
    "attn_decode": (np.array([[0, 3, 6, -1], [1, 4, -1, -1],
                              [2, 5, 7, -1]], np.int32),
                    np.array([17, 9, 21]), 64, 4, 8),
    "moe_a2a": (np.random.default_rng(0).integers(0, 8, size=64)
                .astype(np.int32), 8, 16),
    "ssm_scan": (2, 64, 16, 4),
}

#: --check pins: the whole-llama3_2_1b-step winner on raw time, the
#: attn_decode kernel's winner, and whether the first flips the second
PIN_MODEL_WINNER = "16B"
PIN_ATTN_KERNEL_WINNER = "4R-1W"
PIN_FLIPS = True
#: --check pin of the streamed-step gate
PEAK_HEADROOM = 2.0   # the dense matrix must be >= 2x the streamed peak


def workloads(smoke: bool = False, device="cuda"):
    cfgs = CONFIGS[:1] if smoke else CONFIGS
    return [model_workload(c, batch=BATCH, prompt_len=PROMPT_LEN,
                           page_len=PAGE_LEN, block_ops=BLOCK_OPS,
                           device=device)
            for c in cfgs]


def rows(smoke: bool = False, device="cuda"):
    out = []
    for rec in sweep(PAPER_ARCHITECTURES, workloads(smoke, device),
                     device=device):
        out.append({
            "name": f"{rec['workload']}_{rec['arch']}",
            "workload": rec["workload"], "arch": rec["arch"],
            "us_per_call": round(rec["time_us"], 2),
            "us_per_token": round(rec["time_us"] / rec["n_tokens"], 4),
            "total_cycles": rec["total_cycles"],
            "load_cycles": rec["load_cycles"],
            "store_cycles": rec["store_cycles"],
            "r_bank_eff": rec["r_bank_eff"],
            "w_bank_eff": rec["w_bank_eff"],
        })
    return out


def ranking_report(smoke: bool = False, device="cuda") -> dict:
    """The headline: whole-step winners per model config against the
    winners of the three layer kernels in isolation (flip or no flip)."""
    from repro_torch import tune
    kernel_winners = {
        name: tune.search(kernel=name, workload=args, device=device)[0].arch
        for name, args in KERNEL_POINTS.items()}
    model_winners = {}
    for wl in workloads(smoke, device):
        best = tune.search(workload=wl, device=device)[0]
        model_winners[wl.meta["model"]] = {
            "arch": best.arch, "time_us": round(best.time_us, 2),
            "us_per_token": round(best.time_us / wl.meta["n_tokens"], 4)}
    llama = model_winners.get("llama3.2-1b", {}).get("arch")
    return {
        "kernel_winners": kernel_winners,
        "model_winners": model_winners,
        "llama_flips_attn_kernel": bool(
            llama and llama != kernel_winners["attn_decode"]),
    }


# -- --check gates -----------------------------------------------------------

def check_streamed_step(device="cuda") -> dict:
    """Price a whole mixtral_8x22b decode step (56 MoE layers) through the
    stream and bound the host peak against the dense matrix it must never
    build.  The peak is ``tracemalloc``'s (the numpy blocks) plus the
    engine's staging buffers alive at once (``pinned_bytes``)."""
    from repro_torch.core import arch as _arch
    from repro_torch.core import cost_engine as CE
    wl = model_workload("mixtral_8x22b", batch=BATCH, prompt_len=PROMPT_LEN,
                        page_len=PAGE_LEN, block_ops=BLOCK_OPS,
                        device=device)
    archs = [_arch.resolve(a.name) for a in PAPER_ARCHITECTURES]
    stream = wl.stream_fn(archs[0])
    n_ops = sum(b.n_ops for b in stream.blocks(block_ops=BLOCK_OPS))
    t0 = time.perf_counter()
    costs = CE.cost_many(archs, stream, block_ops=BLOCK_OPS, device=device)
    price_s = time.perf_counter() - t0
    CE.STAGING.reset()
    tracemalloc.start()
    try:
        CE.cost_many(archs, stream, block_ops=BLOCK_OPS, device=device)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    pinned = CE.STAGING.peak
    dense = n_ops * 16 * 4
    return {"workload": "check_streamed_step", "model": "mixtral-8x22b",
            "n_ops": int(n_ops), "price_s": round(price_s, 2),
            "stream_peak_bytes": int(peak),
            "pinned_bytes": int(pinned),
            "dense_matrix_bytes": int(dense),
            "total_cycles_16B": costs[[a.name for a in archs].index(
                "16B")].total_cycles,
            "ok": bool(dense >= PEAK_HEADROOM * (peak + pinned))}


def check(ranking: dict, device="cuda") -> tuple[list, list]:
    """The --check gates: returns (check rows, failure messages)."""
    failures = []
    llama = ranking["model_winners"].get("llama3.2-1b", {}).get("arch")
    if llama != PIN_MODEL_WINNER:
        failures.append(
            f"llama3.2-1b whole-step winner {llama!r} != pinned "
            f"{PIN_MODEL_WINNER!r}")
    attn = ranking["kernel_winners"]["attn_decode"]
    if attn != PIN_ATTN_KERNEL_WINNER:
        failures.append(
            f"attn_decode kernel winner {attn!r} != pinned "
            f"{PIN_ATTN_KERNEL_WINNER!r}")
    if ranking["llama_flips_attn_kernel"] != PIN_FLIPS:
        failures.append(
            f"flip verdict changed: whole-step vs attn_decode kernel "
            f"winner flip={ranking['llama_flips_attn_kernel']}, "
            f"pinned {PIN_FLIPS}")
    step = check_streamed_step(device)
    if not step["ok"]:
        failures.append(
            f"streamed mixtral step peaked at {step['stream_peak_bytes']} B"
            f" + {step['pinned_bytes']} B staged; need ≤ dense matrix "
            f"{step['dense_matrix_bytes']} B / {PEAK_HEADROOM}")
    return [step], failures


def main(argv=None) -> dict:
    """Print the rows and the ranking and write the JSON record; returns
    the record's section."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.model_traffic_bench",
        description="Whole-model decode traffic priced on the nine paper "
                    "memories, and the whole-step vs per-kernel ranking.")
    ap.add_argument("--smoke", action="store_true",
                    help="llama3_2_1b only")
    ap.add_argument("--check", action="store_true",
                    help="run the gates; exit non-zero where one fails")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing and page allocation run "
                         "(default: cuda)")
    ap.add_argument("--out", type=Path, default=OUT_JSON,
                    help=f"the JSON record (default: {OUT_JSON})")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("model_traffic_bench: no CUDA device; pricing runs "
                         "on the card (pass --device cpu to run on the "
                         "host)")
    head = {"device": args.device,
            "nvidia_smi": (card_name_and_power() if args.device == "cuda"
                           else None)}
    out = rows(smoke=args.smoke, device=args.device)
    for r in out:
        extra = "|".join(f"{k}={v}" for k, v in r.items()
                         if k not in ("name", "us_per_call", "workload",
                                      "arch"))
        print(f"{r['name']},{r['us_per_call']},{extra}")
    ranking = ranking_report(smoke=args.smoke, device=args.device)
    print("# kernel winners "
          + "; ".join(f"{k}->{v}"
                      for k, v in sorted(ranking["kernel_winners"].items()))
          + "; model winners "
          + "; ".join(f"{k}->{v['arch']}"
                      for k, v in sorted(ranking["model_winners"].items()))
          + ("; llama flips attn_decode winner"
             if ranking["llama_flips_attn_kernel"] else "; no flip"))
    check_rows, failures = ([], [])
    if args.check:
        check_rows, failures = check(ranking, device=args.device)
    section = {
        "smoke": args.smoke,
        "grid": {"configs": list(CONFIGS), "batch": BATCH,
                 "prompt_len": PROMPT_LEN, "page_len": PAGE_LEN,
                 "block_ops": BLOCK_OPS},
        "rows": out, "ranking": ranking, "checks": check_rows,
    }
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({**head, "model": section}, indent=2)
                        + "\n")
    print(f"# wrote model section to {args.out}")
    if args.check:
        if failures:
            for msg in failures:
                print(f"# CHECK FAILED: {msg}", file=sys.stderr)
            raise SystemExit(1)
        print("# check OK: model winner pinned, flip verdict holds, "
              "streamed step bounded")
    return section


if __name__ == "__main__":
    main()
