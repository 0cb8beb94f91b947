"""Serving benchmark on the card (the counterpart of
``benchmarks/serving_bench.py``): paged-KV prefill and decode traffic
priced on every paper memory.

    python -m repro_torch.bench.serving_bench [--smoke] [--check] [--chaos]
        [--device cuda|cpu] [--out PATH]

Two sections:

  * ``serving_*`` rows — fixed-batch (batch, context) points of
    ``bench.serving_workload``: the page allocator runs per architecture,
    the prefill page writes and every decode step lower to one
    ``AddressTrace``, and ``sweep`` prices it like any Table II/III cell;
  * ``sched_*`` rows — continuous-batching serving days of
    ``bench.scheduler_workload``: an arrival-rate × context-distribution
    grid scheduled lane-ragged by ``serving.scheduler``, priced per token
    through the streaming ``Trace`` protocol.  Each day's raw-time winner
    is reported against the fixed-batch winner: the ranking flip that
    multi-tenant load causes.

CSV: name,us_per_call,derived.  ``--smoke`` runs the smallest points
only.  ``--check`` also runs three gates and exits non-zero if one fails:

  * the live check: a small ``ServeEngine.run_scheduler`` day of the
    smoke ``llama3.2-1b`` (the port's own seeded weights; the trace does
    not depend on them) on ``--device``, whose recorded trace is bit-equal
    to the simulated lowering, with the pinned op count and cycles;
  * a 1000-request simulated day priced through the stream, whose host
    peak (``tracemalloc``'s, plus the engine's staging buffers, which
    torch allocates and ``tracemalloc`` does not see) stays well under the
    dense (ops × 16) matrix it never builds;
  * at least one ranking flip against the fixed-batch winner (pinned: the
    low-arrival days flip to 4R-1W).

``--chaos`` runs the fault section instead (CI: ``--chaos --smoke
--check``): the pinned small day under a seeded ``runtime.FaultPlan`` (a
bank loss, an ECC page corruption, a transient decode fault), priced
healthy, faulted, and faulted on the degraded ``!d`` variant.  Its gates:
the faulted stream passes ``analysis.validate`` twice (it can be iterated
again), the faulted day costs more than the healthy one, the degraded
variant at least as much, and the three cycle counts equal their pins.

Pricing runs on the card unless ``--device cpu`` is given (without a card
the command fails instead of running on the host).  The JSON goes to
``--out`` (default ``build/serving_bench.json`` in the checkout), a
section at a time, with the card's name and power limit; the reference's
``BENCH_cost.json`` is never written.
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

from repro_torch.bench import scheduler_workload, serving_workload, sweep
from repro_torch.bench.cost_bench import card_name_and_power
from repro_torch.core.arch import PAPER_ARCHITECTURES

OUT_JSON = Path(__file__).resolve().parents[3] / "build" / "serving_bench.json"

#: (batch, prompt_len, decode_steps) grid: small / medium / large context
POINTS = ((4, 32, 32), (8, 64, 64), (16, 128, 128))
PAGE_LEN = 8
N_KV_LAYERS = 2

#: (arrival_rate, context_dist) grid of the continuous-batching section:
#: low / high load × short / long / mixed tenancy, one seeded day a cell
SCHED_POINTS = ((0.5, "short"), (0.5, "long"), (1.0, "mixed"),
                (4.0, "short"), (4.0, "long"))
SCHED_N_REQUESTS = 64
SCHED_LANES = 8
SCHED_MAX_SEQ = 128

#: the fixed-batch serving point whose raw-time winner is 4R-2W
FIXED_POINT = dict(batch=4, prompt_len=16, decode_steps=8, page_len=4,
                   n_kv_layers=2)

#: --check pins of the live-vs-simulated gate (llama3.2-1b smoke config,
#: 4 lanes, max_seq 32, page_len 8, seq-skew policy)
CHECK_TRAFFIC = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0), (2, 9, 5),
                 (3, 12, 3))          # (arrival, prompt_len, max_new)
CHECK_N_OPS = 80
CHECK_CYCLES = {"16B": 2800, "4R-2W": 128}
#: --check pins of the streamed serving-day gate
DAY_REQUESTS = 1000
DAY_PEAK_HEADROOM = 2.0   # the dense matrix must be >= 2x the streamed peak

#: --chaos pins: CHECK_TRAFFIC under the seeded fault plan below on
#: 16B-xor, priced healthy / faulted / faulted on the degraded variant
CHAOS_ARCH = "16B-xor"
CHAOS_DEAD_BANKS = (1,)
CHAOS_CYCLES = {"healthy": 2800, "faulted": 4660, "faulted_degraded": 4668}


def workloads(smoke: bool = False, device="cuda"):
    pts = POINTS[:1] if smoke else POINTS
    return [serving_workload(batch=b, prompt_len=p, decode_steps=d,
                             page_len=PAGE_LEN, n_kv_layers=N_KV_LAYERS,
                             device=device)
            for b, p, d in pts]


def sched_workloads(smoke: bool = False):
    pts = SCHED_POINTS[:2] if smoke else SCHED_POINTS
    return [scheduler_workload(n_requests=SCHED_N_REQUESTS, arrival_rate=r,
                               context_dist=d, n_lanes=SCHED_LANES,
                               max_seq=SCHED_MAX_SEQ, page_len=PAGE_LEN,
                               n_kv_layers=N_KV_LAYERS, seed=0)
            for r, d in pts]


def rows(smoke: bool = False, device="cuda"):
    out = []
    for rec in sweep(PAPER_ARCHITECTURES, workloads(smoke, device),
                     device=device):
        out.append({
            "name": f"serving_{rec['workload']}_{rec['arch']}",
            "us_per_call": round(rec["time_us"], 2),
            "total_cycles": rec["total_cycles"],
            "load_cycles": rec["load_cycles"],
            "store_cycles": rec["store_cycles"],
            "r_bank_eff": rec["r_bank_eff"],
            "w_bank_eff": rec["w_bank_eff"],
        })
    return out


def sched_rows(smoke: bool = False, device="cuda"):
    out = []
    for rec in sweep(PAPER_ARCHITECTURES, sched_workloads(smoke),
                     device=device):
        out.append({
            "name": f"{rec['workload']}_{rec['arch']}",
            "workload": rec["workload"], "arch": rec["arch"],
            "us_per_call": round(rec["time_us"], 2),
            "us_per_token": round(rec["time_us"] / rec["n_tokens"], 4),
            "total_cycles": rec["total_cycles"],
            "load_cycles": rec["load_cycles"],
            "store_cycles": rec["store_cycles"],
            "w_bank_eff": rec["w_bank_eff"],
        })
    return out


def ranking_flip_report(sched: list, device="cuda") -> dict:
    """Each day's raw-time winner against the fixed-batch serving winner:
    does multi-tenant load change which memory wins?"""
    from repro_torch import tune
    fixed = tune.search(
        workload=serving_workload(**FIXED_POINT, device=device),
        device=device)
    fixed_winner = fixed[0].arch
    winners = {}
    for r in sched:
        w = winners.get(r["workload"])
        if w is None or r["us_per_token"] < w[1]:
            winners[r["workload"]] = (r["arch"], r["us_per_token"])
    report = {
        "fixed_batch_winner": fixed_winner,
        "day_winners": {k: {"arch": a, "us_per_token": u}
                        for k, (a, u) in winners.items()},
        "flips": sorted(k for k, (a, _) in winners.items()
                        if a != fixed_winner),
    }
    report["has_flip"] = bool(report["flips"])
    return report


# -- --check gates -----------------------------------------------------------

def implied_row_launches(stream, n_kv: int) -> dict:
    """The paired row launches a recorded scheduler day implies: per KV
    layer, a gather and a scatter for each decode step (replays included)
    and each migration, a scatter for each prefill ingest or chunk
    (re-prefills included)."""
    gathers = scatters = 0
    for blk in stream:
        what = blk.meta["what"]
        gathers += what.startswith("sched_decode") or what == "fault_migrate"
        scatters += 1
    return {"banked_gather": n_kv * gathers,
            "banked_scatter": n_kv * scatters}


def check_live_equals_sim(device="cuda") -> dict:
    """A small live ``run_scheduler`` day against the simulated lowering:
    identical trace bytes, the pinned op count and cycles.  The row also
    carries the paired row launches the day implies (``row_launches``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import arch as A
    from repro_torch.launch.sharding import NO_AXES
    from repro_torch.models import init_tree, model_specs
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import (Request,
                                               simulate_scheduler_stream)
    cfg = get_smoke_config("llama3.2-1b")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_tree(model_specs(cfg), gen, device=device)
    eng = ServeEngine(cfg, RunConfig(remat="none", attn_impl="dense"),
                      params, NO_AXES,
                      max_batch=4, max_seq=32, kv_mode="paged",
                      page_len=8, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, arrival=a, prompt_len=p, max_new_tokens=m,
                    tokens=rng.integers(0, cfg.vocab_size,
                                        p).astype(np.int32))
            for i, (a, p, m) in enumerate(CHECK_TRAFFIC)]
    eng.run_scheduler(reqs, policy="seq-skew")
    stream = eng.scheduler_stream()
    live = stream.materialize()  # lint: allow-materialize — 80 ops
    sim = simulate_scheduler_stream(
        eng.mem_arch, reqs, n_lanes=4, max_seq=32, page_len=8,
        n_kv_layers=eng.n_kv_layers, policy="seq-skew").materialize()  # lint: allow-materialize
    bit_equal = (np.array_equal(live.addrs, sim.addrs)
                 and np.array_equal(live.kinds, sim.kinds)
                 and np.array_equal(live.instr, sim.instr)
                 and np.array_equal(np.asarray(live.mask),
                                    np.asarray(sim.mask)))
    cycles = {n: A.get(n).cost(live, device=device).total_cycles
              for n in CHECK_CYCLES}
    return {"workload": "check_live_vs_sim", "n_ops": int(live.n_ops),
            "bit_equal": bool(bit_equal),
            "cycles": cycles,
            "ok": bool(bit_equal and live.n_ops == CHECK_N_OPS
                       and cycles == CHECK_CYCLES),
            "row_launches": implied_row_launches(stream, eng.n_kv_layers)}


def check_streamed_day(device="cuda") -> dict:
    """Price a 1000-request serving day through the stream and bound the
    host peak against the dense matrix it must never build.  The peak is
    ``tracemalloc``'s (the numpy blocks) plus the engine's staging buffers
    alive at once (``pinned_bytes``: torch allocates them, pinned on the
    card, and ``tracemalloc`` does not see them)."""
    from repro_torch.core import arch as _arch
    from repro_torch.core import cost_engine as CE
    wl = scheduler_workload(n_requests=DAY_REQUESTS, arrival_rate=2.0,
                            context_dist="long", n_lanes=16, max_seq=256,
                            page_len=PAGE_LEN, n_kv_layers=N_KV_LAYERS,
                            seed=0)
    archs = [_arch.resolve(a.name) for a in PAPER_ARCHITECTURES]
    stream = wl.stream_fn(archs[0])
    n_ops = sum(b.n_ops for b in stream.blocks(block_ops=4096))
    t0 = time.perf_counter()
    costs = CE.cost_many(archs, stream, block_ops=4096, device=device)
    price_s = time.perf_counter() - t0
    CE.STAGING.reset()
    tracemalloc.start()
    try:
        CE.cost_many(archs, stream, block_ops=4096, device=device)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    pinned = CE.STAGING.peak
    dense = n_ops * 16 * 4
    return {"workload": "check_streamed_day", "n_requests": DAY_REQUESTS,
            "n_tokens": wl.meta["n_tokens"], "n_ops": int(n_ops),
            "price_s": round(price_s, 2),
            "stream_peak_bytes": int(peak),
            "pinned_bytes": int(pinned),
            "dense_matrix_bytes": int(dense),
            "total_cycles_16B": costs[[a.name for a in archs].index(
                "16B")].total_cycles,
            "ok": bool(dense >= DAY_PEAK_HEADROOM * (peak + pinned))}


def chaos_plan():
    """The seeded chaos day: one of every recoverable fault kind."""
    from repro_torch.runtime import FaultEvent, FaultPlan
    return FaultPlan((
        FaultEvent(tick=3, kind="bank_offline", bank=CHAOS_DEAD_BANKS[0]),
        FaultEvent(tick=5, kind="page_corrupt", rid=0, page_idx=0),
        FaultEvent(tick=6, kind="decode_transient", failures=2),
    ))


def chaos_section(device="cuda") -> tuple[dict, list]:
    """The --chaos gate: the pinned small day under the seeded fault plan,
    its recovery traffic priced on the healthy memory and on its degraded
    surviving-bank variant.  Returns (row, failure messages)."""
    from repro_torch.analysis import validate
    from repro_torch.core import arch as A
    from repro_torch.core.cost_engine import cost_many
    from repro_torch.serving.scheduler import (Request,
                                               simulate_scheduler_stream)
    plan = chaos_plan()
    reqs = [Request(rid=i, arrival=a, prompt_len=p, max_new_tokens=m)
            for i, (a, p, m) in enumerate(CHECK_TRAFFIC)]
    base = A.get(CHAOS_ARCH)
    deg = base.degrade(CHAOS_DEAD_BANKS)
    kw = dict(n_lanes=4, max_seq=32, page_len=PAGE_LEN,
              n_kv_layers=N_KV_LAYERS)
    healthy = simulate_scheduler_stream(base, reqs, **kw)
    faulted = simulate_scheduler_stream(base, reqs, fault_plan=plan, **kw)
    rep1 = validate(faulted, arch=CHAOS_ARCH, block_ops=64)
    rep2 = validate(faulted, arch=CHAOS_ARCH, block_ops=64)  # re-iterable
    healthy_c = int(cost_many([base], healthy, device=device)[0]
                    .total_cycles)
    f_base, f_deg = (int(c.total_cycles)
                     for c in cost_many([base, deg], faulted, device=device))
    cycles = {"healthy": healthy_c, "faulted": f_base,
              "faulted_degraded": f_deg}
    failures = []
    if not (rep1.ok and rep2.ok and rep1.n_ops == rep2.n_ops):
        failures.append(
            f"faulted day fails the trace contract or is not re-iterable "
            f"({rep1.violations or rep2.violations})")
    if not f_base > healthy_c:
        failures.append(
            f"faulted day ({f_base} cycles) should cost strictly more than "
            f"the healthy day ({healthy_c}): where did the migration and "
            f"replay traffic go?")
    if not f_deg >= f_base:
        failures.append(
            f"degraded variant {deg.name} prices the faulted day at "
            f"{f_deg} < healthy arch's {f_base} — the surviving-bank remap "
            f"can only add conflicts")
    if cycles != CHAOS_CYCLES:
        failures.append(f"chaos cycles {cycles} != pinned {CHAOS_CYCLES}")
    row = {"workload": "chaos_day", "arch": CHAOS_ARCH,
           "degraded_arch": deg.name, "plan": plan.counts(),
           "validate_ok": bool(rep1.ok and rep2.ok),
           "n_ops": int(rep1.n_ops), "cycles": cycles,
           "ok": not failures}
    return row, failures


def check(sched: list, flips: dict, device="cuda") -> tuple[list, list]:
    """The --check gates: returns (check rows, failure messages)."""
    failures = []
    live = check_live_equals_sim(device)
    if not live["ok"]:
        failures.append(
            f"live run_scheduler trace != simulated lowering (bit_equal="
            f"{live['bit_equal']}, n_ops={live['n_ops']} want {CHECK_N_OPS},"
            f" cycles={live['cycles']} want {CHECK_CYCLES})")
    day = check_streamed_day(device)
    if not day["ok"]:
        failures.append(
            f"streamed {DAY_REQUESTS}-request day peaked at "
            f"{day['stream_peak_bytes']} B + {day['pinned_bytes']} B "
            f"staged; need ≤ dense matrix {day['dense_matrix_bytes']} B / "
            f"{DAY_PEAK_HEADROOM}")
    if not flips["has_flip"]:
        failures.append(
            f"no arch-ranking flip vs fixed-batch winner "
            f"{flips['fixed_batch_winner']} across {len(flips['day_winners'])}"
            f" scheduler days — the pinned low-arrival 4R-1W flip is gone")
    return [live, day], failures


def _write_section(out: Path, key: str, section, head: dict) -> None:
    """Add ``section`` under ``key`` to the JSON record at ``out`` (other
    sections kept), with ``head`` at the top level."""
    payload = json.loads(out.read_text()) if out.exists() else {}
    payload.update(head)
    payload[key] = section
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(payload, indent=2) + "\n")


def _fail(failures: list, what: str) -> None:
    if failures:
        for msg in failures:
            print(f"# {what} FAILED: {msg}", file=sys.stderr)
        raise SystemExit(1)


def main(argv=None) -> dict:
    """Print the rows and write the JSON section; returns the section."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.serving_bench",
        description="Paged-KV serving traffic priced on the paper "
                    "memories: fixed-batch points, scheduled days and "
                    "their ranking flip, and the fault section.")
    ap.add_argument("--smoke", action="store_true",
                    help="the smallest points only")
    ap.add_argument("--check", action="store_true",
                    help="run the gates; exit non-zero where one fails")
    ap.add_argument("--chaos", action="store_true",
                    help="run the fault section instead")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing and the live check run "
                         "(default: cuda)")
    ap.add_argument("--out", type=Path, default=OUT_JSON,
                    help=f"the JSON record (default: {OUT_JSON})")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serving_bench: no CUDA device; pricing runs on "
                         "the card (pass --device cpu to run on the host)")
    head = {"device": args.device,
            "nvidia_smi": (card_name_and_power() if args.device == "cuda"
                           else None)}
    if args.chaos:
        row, failures = chaos_section(args.device)
        print(f"chaos_{row['arch']},cycles={row['cycles']['healthy']}"
              f"->{row['cycles']['faulted']}"
              f" (degraded {row['degraded_arch']}:"
              f" {row['cycles']['faulted_degraded']})"
              f",validate_ok={row['validate_ok']},n_ops={row['n_ops']}")
        _write_section(args.out, "faults", row, head)
        print(f"# appended faults section to {args.out}")
        if args.check:
            _fail(failures, "CHAOS CHECK")
            print("# chaos check OK: faulted day validates, recovery "
                  "traffic priced, degraded-variant cycles pinned")
        return {"faults": row}
    out = rows(smoke=args.smoke, device=args.device)
    sched = sched_rows(smoke=args.smoke, device=args.device)
    for r in out + sched:
        extra = "|".join(f"{k}={v}" for k, v in r.items()
                         if k not in ("name", "us_per_call", "workload",
                                      "arch"))
        print(f"{r['name']},{r['us_per_call']},{extra}")
    flips = ranking_flip_report(sched, device=args.device)
    print(f"# fixed-batch winner {flips['fixed_batch_winner']}; day winners "
          + "; ".join(f"{k}->{v['arch']}"
                      for k, v in sorted(flips["day_winners"].items()))
          + (f"; flips: {', '.join(flips['flips'])}" if flips["has_flip"]
             else "; no flip"))
    check_rows, failures = ([], [])
    if args.check:
        check_rows, failures = check(sched, flips, device=args.device)
    section = {
        "smoke": args.smoke,
        "grid": {"points": [list(p) for p in SCHED_POINTS],
                 "n_requests": SCHED_N_REQUESTS, "n_lanes": SCHED_LANES,
                 "max_seq": SCHED_MAX_SEQ},
        "rows": sched, "ranking": flips, "checks": check_rows,
    }
    _write_section(args.out, "scheduler", section, head)
    print(f"# appended scheduler section to {args.out}")
    if args.check:
        _fail(failures, "CHECK")
        print("# check OK: live==sim pinned, streamed day bounded, "
              "ranking flip present")
    return {"serving": out, "scheduler": section}


if __name__ == "__main__":
    main()
