"""Cost-engine benchmark on the card (the counterpart of
``benchmarks/cost_bench.py``): what an architect waits for when pricing a
lattice, timed over the batched streaming engine
(``repro_torch.core.cost_engine``) and the per-architecture loop.

    python -m repro_torch.bench.cost_bench [--smoke] [--check]
        [--device cuda|cpu] [--out PATH]

For each workload trace three costing paths are timed against the paper
lattice (``tune.PAPER_SPACE``, 9 architectures):

  * ``loop``    — one ``MemoryArchitecture._cost_loop`` call per
                  architecture (a host sync per op kind each);
  * ``batched`` — one ``cost_many`` pass (one device sync in all);
  * ``stream``  — ``cost_many`` over O(block) chunks.

All three are checked bit-equal before timing.  The streamed section also
prices a >1e6-op synthetic serving stream that is never built densely.
The construction rows time building + lowering + pricing the N×N transpose
program dense (``program_trace``) against streamed
(``instr_trace_blocks``, one block alive at a time), with the host peak
from ``tracemalloc`` (blocks are numpy arrays, which it sees; device
buffers are not host construction).  ``pipelined_*`` prices a
latency-bound ``TraceStream.from_thunks`` stream serially and with
``prefetch=``; ``warm_cache_*`` re-prices a rolling window that shares 90%
of its blocks with the previous one through a seeded ``BlockCostCache``
against an all-miss pass, on the full architecture registry.

Pricing runs on the card unless ``--device cpu`` is given (without a card
the command fails instead of running on the host); every timing ends in a
device sync.  CSV: name,us_per_call,derived.  ``--smoke`` runs the small
points only.  ``--check`` exits non-zero where the reference's gates fail:
batched under ``CHECK_SPEEDUP``× the loop, pipelined under
``PIPELINE_SPEEDUP``× serial, warm cache under ``WARM_CACHE_SPEEDUP``×
cold, any path not bit-equal, a streamed construction peak at or above
``max(dense_matrix_bytes, PEAK_FLOOR_BYTES)``, or a throughput under its
``OPS_PER_S_FLOORS`` floor.  The JSON goes to ``--out`` (default
``build/cost_bench.json`` in the checkout) with the card's name and power
limit; the reference's ``BENCH_cost.json`` is never written.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import tracemalloc
from pathlib import Path

import numpy as np
import torch

from repro_torch.bench.workloads import fft_workload, transpose_workload
from repro_torch.core import arch as _arch
from repro_torch.core.cost_engine import BlockCostCache, cost_many
from repro_torch.core.trace import AddressTrace, TraceStream
from repro_torch.tune.search import PAPER_SPACE

OUT_JSON = Path(__file__).resolve().parents[3] / "build" / "cost_bench.json"

#: the default ArchSpace — the lattice `tune.search` prices (9 points)
ARCH_NAMES = tuple(PAPER_SPACE.names())
STREAM_BLOCK_OPS = 4096
CHECK_SPEEDUP = 2.0       # batched vs the per-architecture loop
PIPELINE_SPEEDUP = 2.0    # prefetch pipeline vs serial, latency-bound stream
WARM_CACHE_SPEEDUP = 5.0  # seeded BlockCostCache vs all-miss, 90%-shared window
#: a streamed build may hold a few blocks in flight (current block, pending
#: coalesce, staging) but never O(trace); the floor (a handful of block
#: footprints, block_ops x 16 lanes x 4 B) keeps small traces gated too
PEAK_FLOOR_BYTES = 8 * STREAM_BLOCK_OPS * 16 * 4
#: throughput floors (ops/s), the reference's gross-regression tripwires
OPS_PER_S_FLOORS = {
    "stream_synthetic_serving": ("ops_per_s", 2_000),
    "construct_transpose256": ("stream_build_ops_per_s", 50_000),
    "construct_transpose1024": ("stream_build_ops_per_s", 50_000),
}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timeit(fn, device, repeats: int = 5) -> float:
    """Best-of-N wall seconds after one untimed warmup, each run ended by
    a device sync."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _serving_trace_16b(batch, prompt_len, decode_steps, page_len, device):
    """One fixed (16B-lowered) serving trace priced under every point —
    the same input work for all three costing paths."""
    from repro_torch.serving.kvcache import simulate_serving_trace
    return simulate_serving_trace("16B", batch=batch, prompt_len=prompt_len,
                                  decode_steps=decode_steps,
                                  page_len=page_len, n_kv_layers=2,
                                  device=device)


def _cases(smoke: bool, device="cuda"):
    yield "transpose32", transpose_workload(32).trace()
    yield "serve_b4_p16_d8", _serving_trace_16b(4, 16, 8, 4, device)
    if smoke:
        return
    yield "transpose64", transpose_workload(64).trace()
    yield "transpose128", transpose_workload(128).trace()
    yield "fft4096r4", fft_workload(4096, 4).trace()
    yield "serve_b8_p64_d64", _serving_trace_16b(8, 64, 64, 8, device)


def _cycles_16b(archs, costs) -> int:
    return costs[[a.name for a in archs].index("16B")].total_cycles


def bench_case(name: str, trace, archs, device="cuda") -> dict:
    def loop():
        return [a._cost_loop(trace, device=device) for a in archs]

    def batched():
        return cost_many(archs, trace, device=device)

    def streamed():
        return cost_many(archs, trace, block_ops=STREAM_BLOCK_OPS,
                         device=device)

    want, many = loop(), batched()
    equal = many == want and streamed() == want
    loop_s = _timeit(loop, device)
    many_s = _timeit(batched, device)
    stream_s = _timeit(streamed, device)
    return {
        "workload": name, "n_ops": trace.n_ops, "n_archs": len(archs),
        "loop_s": round(loop_s, 6), "cost_many_s": round(many_s, 6),
        "stream_s": round(stream_s, 6),
        "speedup_many": round(loop_s / many_s, 2),
        "speedup_stream": round(loop_s / stream_s, 2),
        "cycles_equal": bool(equal),
        "total_cycles_16B": _cycles_16b(archs, many),
    }


def bench_million_op_stream(archs, smoke: bool, device="cuda") -> dict:
    """Price a >1e6-op synthetic serving stream (repeated decode-step
    blocks) through the lazy path; the dense (ops × 16) matrix is never
    built.  Linearity against one block priced densely is checked."""
    base = _serving_trace_16b(8, 16, 16, 4, device)   # one block of traffic
    repeats = 8 if smoke else (1_000_000 // base.n_ops + 1)

    def blocks():
        for _ in range(repeats):
            yield base

    stream = TraceStream(blocks, meta={"what": "synthetic-serving"})
    n_ops = repeats * base.n_ops
    _sync(device)
    t0 = time.perf_counter()
    totals = cost_many(archs, stream, block_ops=STREAM_BLOCK_OPS,
                       device=device)
    _sync(device)
    stream_s = time.perf_counter() - t0
    one = cost_many(archs, base, device=device)
    linear = all(t.total_cycles == repeats * o.total_cycles
                 for t, o in zip(totals, one))
    return {
        "workload": "stream_synthetic_serving", "n_ops": n_ops,
        "n_archs": len(archs), "blocks": repeats,
        "block_ops": STREAM_BLOCK_OPS, "stream_s": round(stream_s, 4),
        "ops_per_s": int(n_ops / stream_s),
        "prefix_bit_equal": bool(linear),
        "total_cycles_16B": _cycles_16b(archs, totals),
    }


def _peak_bytes(fn) -> int:
    """Host (tracemalloc) peak bytes allocated while running ``fn``: numpy
    buffers included, device buffers not."""
    tracemalloc.start()
    try:
        fn()
        return tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def construction_stream(n: int) -> TraceStream:
    """The N×N transpose's lazy trace: ``instr_trace_blocks`` over its
    macro-op iterator, ``STREAM_BLOCK_OPS`` ops a block."""
    from repro_torch.isa.programs.transpose import (iter_transpose_instrs,
                                                    transpose_n_threads)
    from repro_torch.isa.vm import instr_trace_blocks
    return TraceStream(lambda: instr_trace_blocks(
        iter_transpose_instrs(n), transpose_n_threads(n), STREAM_BLOCK_OPS))


def bench_construction(n: int, with_dense: bool, device="cuda") -> dict:
    """Trace construction on the N×N transpose: build + lower + price
    under 16B, dense (``program_trace`` of the whole program) against
    streamed (``instr_trace_blocks`` over the lazy macro-op iterator).

    ``with_dense=False`` rows are the million-op class: they record the
    streamed peak against ``dense_matrix_bytes``, the (ops × 16) int32
    matrix never built.  Every row is ``peak_gated``."""
    from repro_torch.isa.programs.transpose import transpose_program
    from repro_torch.isa.vm import program_trace
    a16 = _arch.resolve("16B")
    n_ops = 2 * n * n // 16        # the load + store op streams

    def build_stream():
        return cost_many([a16], construction_stream(n),
                         block_ops=STREAM_BLOCK_OPS, device=device)[0]

    def build_dense():
        return cost_many([a16], program_trace(transpose_program(n)),
                         device=device)[0]

    stream_cost = build_stream()            # warmup + checksum
    _sync(device)
    stream_peak = _peak_bytes(build_stream)
    stream_s = _timeit(build_stream, device, repeats=3)
    row = {
        "workload": f"construct_transpose{n}", "n_ops": n_ops,
        "block_ops": STREAM_BLOCK_OPS,
        "dense_matrix_bytes": n_ops * 16 * 4,
        "stream_peak_bytes": int(stream_peak),
        "stream_s": round(stream_s, 4),
        "stream_build_ops_per_s": int(n_ops / stream_s),
        "peak_gated": True,
        "peak_floor_bytes": PEAK_FLOOR_BYTES,
        "total_cycles_16B": stream_cost.total_cycles,
    }
    if with_dense:
        dense_cost = build_dense()
        _sync(device)
        dense_peak = _peak_bytes(build_dense)
        dense_s = _timeit(build_dense, device, repeats=3)
        row.update({
            "dense_peak_bytes": int(dense_peak),
            "dense_s": round(dense_s, 4),
            "construction_bit_equal": bool(dense_cost == stream_cost),
            "construction_peak_ratio": round(
                dense_peak / max(stream_peak, 1), 2),
        })
    return row


def _synthetic_block(i: int, n_ops: int = 512) -> AddressTrace:
    """A deterministic block distinct per index (so its cache digest is
    distinct); stride-varied addresses keep the conflicts non-trivial."""
    addrs = ((np.arange(n_ops * 16, dtype=np.int64) * (2 * i + 3)) % 509
             ).reshape(n_ops, 16).astype(np.int32)
    return AddressTrace.from_ops(addrs, kind="load" if i % 2 == 0
                                 else "store")


def bench_pipelined(prefetch: int = 4, n_blocks: int = 8,
                    lat_s: float = 0.006, device="cuda") -> dict:
    """A latency-bound thunk stream priced serially and through
    ``cost_many(..., prefetch=N)``.

    Each thunk waits ``lat_s`` before returning its pre-built block,
    standing in for an I/O-bound producer (blocks decoded from disk, a live
    scheduler feed): the pipeline's win is latency hiding, which does not
    depend on the host's core count.  Bit-equality with the serial pass is
    checked before timing."""
    a16 = _arch.resolve("16B")
    blocks = [_synthetic_block(i) for i in range(n_blocks)]

    def stream():
        def thunk(b):
            def t():
                time.sleep(lat_s)       # simulated construction latency
                return b
            return t
        return TraceStream.from_thunks([thunk(b) for b in blocks])

    def serial():
        return cost_many([a16], stream(), device=device)

    def piped():
        return cost_many([a16], stream(), prefetch=prefetch, device=device)

    want = serial()
    equal = piped() == want
    serial_s = _timeit(serial, device, repeats=3)
    piped_s = _timeit(piped, device, repeats=3)
    return {
        "workload": "pipelined_thunk_stream",
        "n_blocks": n_blocks, "construct_lat_s": lat_s,
        "prefetch": prefetch,
        "serial_s": round(serial_s, 4), "pipelined_s": round(piped_s, 4),
        "speedup_pipelined": round(serial_s / piped_s, 2),
        "pipelined_bit_equal": bool(equal),
        "total_cycles_16B": want[0].total_cycles,
    }


def bench_warm_cache(archs, window: int = 20, slide: int = 2,
                     block_n_ops: int = 2048, device="cuda") -> dict:
    """Incremental re-pricing: a ``window``-block rolling window slides by
    ``slide`` blocks (90% shared at the defaults).  Cold = the slid window
    priced block by block through a fresh ``BlockCostCache`` (all miss);
    warm = through a cache seeded by the previous window (only the new
    blocks reach the device).  Same code path both sides, so the ratio is
    what the cache saves.  Bit-equality cold == warm is checked."""
    blocks = [_synthetic_block(i, n_ops=block_n_ops)
              for i in range(window + slide)]
    prev = blocks[:window]          # the already-priced window
    cur = blocks[slide:]            # slid: shares window - slide blocks

    def price(cache):
        return cost_many(archs, TraceStream(list(cur)), cache=cache,
                         device=device)

    def seed(cache):
        cost_many(archs, TraceStream(list(prev)), cache=cache, device=device)
        return cache

    cold = price(BlockCostCache())
    seeded = seed(BlockCostCache())
    warm = price(seeded)
    hits = seeded.stats["hits"]
    equal = warm == cold

    # the cache fills itself, so each repeat seeds a fresh one and times
    # only the window's re-price
    cold_s, warm_s = float("inf"), float("inf")
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        price(BlockCostCache())
        _sync(device)
        cold_s = min(cold_s, time.perf_counter() - t0)
        c = seed(BlockCostCache())
        _sync(device)
        t0 = time.perf_counter()
        price(c)
        _sync(device)
        warm_s = min(warm_s, time.perf_counter() - t0)
    return {
        "workload": "warm_cache_window",
        "n_archs": len(archs), "window_blocks": window,
        "shared_blocks": window - slide,
        "cold_s": round(cold_s, 4), "warm_s": round(warm_s, 4),
        "speedup_warm_cache": round(cold_s / warm_s, 2),
        "warm_hits": int(hits),
        "warm_bit_equal": bool(equal),
        "total_cycles_16B": _cycles_16b(archs, cold),
    }


def _construction_rows(smoke: bool, device="cuda") -> list:
    out = [bench_construction(256, with_dense=True, device=device),
           bench_construction(1024, with_dense=True, device=device)]
    if not smoke:
        # 4096² transpose: 2.1e6 ops lowered + priced, never densified
        out.append(bench_construction(4096, with_dense=False, device=device))
    return out


def rows(smoke: bool = False, device="cuda") -> list:
    archs = [_arch.resolve(n) for n in ARCH_NAMES]
    out = [bench_case(name, trace, archs, device)
           for name, trace in _cases(smoke, device)]
    out.append(bench_million_op_stream(archs, smoke, device))
    out.append(bench_pipelined(device=device))
    # the warm-cache gate prices the FULL registry (paper lattice + the
    # non-pow2 and two-level extension)
    out.append(bench_warm_cache([_arch.resolve(n)
                                 for n in sorted(_arch.names())],
                                device=device))
    out.extend(_construction_rows(smoke, device))
    return out


def check(results: list) -> list:
    """The reference's speed and exactness gates; returns the failures."""
    failures = []
    for r in results:
        if "speedup_many" in r and r["speedup_many"] < CHECK_SPEEDUP:
            failures.append(
                f"{r['workload']}: cost_many only {r['speedup_many']}x the "
                f"per-arch loop (< {CHECK_SPEEDUP}x)")
        if r.get("cycles_equal") is False or r.get("prefix_bit_equal") is False:
            failures.append(f"{r['workload']}: engine not bit-equal to loop")
        if r.get("construction_bit_equal") is False:
            failures.append(
                f"{r['workload']}: streamed construction not bit-equal to "
                f"the dense build")
        if "speedup_pipelined" in r:
            if r["speedup_pipelined"] < PIPELINE_SPEEDUP:
                failures.append(
                    f"{r['workload']}: prefetch pipeline only "
                    f"{r['speedup_pipelined']}x serial on the latency-bound "
                    f"stream (< {PIPELINE_SPEEDUP}x)")
            if r.get("pipelined_bit_equal") is False:
                failures.append(
                    f"{r['workload']}: pipelined pass not bit-equal to "
                    f"serial")
        if "speedup_warm_cache" in r:
            if r["speedup_warm_cache"] < WARM_CACHE_SPEEDUP:
                failures.append(
                    f"{r['workload']}: seeded-cache re-price only "
                    f"{r['speedup_warm_cache']}x the all-miss pass "
                    f"(< {WARM_CACHE_SPEEDUP}x on a "
                    f"{r['shared_blocks']}/{r['window_blocks']}-shared "
                    f"window)")
            if r.get("warm_bit_equal") is False:
                failures.append(
                    f"{r['workload']}: warm re-price not bit-equal to cold")
        if r.get("peak_gated"):
            cap = max(r["dense_matrix_bytes"],
                      r.get("peak_floor_bytes", PEAK_FLOOR_BYTES))
            if r["stream_peak_bytes"] >= cap:
                failures.append(
                    f"{r['workload']}: streamed construction peaked at "
                    f"{r['stream_peak_bytes']} B >= "
                    f"max(dense {r['dense_matrix_bytes']} B, floor "
                    f"{PEAK_FLOOR_BYTES} B) — it must stay O(block)")
        floor = OPS_PER_S_FLOORS.get(r["workload"])
        if floor is not None and r.get(floor[0], floor[1]) < floor[1]:
            failures.append(
                f"{r['workload']}: {floor[0]}={r[floor[0]]} under the "
                f"{floor[1]} ops/s regression floor")
    return failures


def card_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them.  A
    failure to read them propagates: a card's record keeps its
    provenance or is not written."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    lines = out.strip().splitlines()
    if not lines:
        raise RuntimeError("cost_bench: nvidia-smi printed no card")
    return lines[0]


def main(argv=None) -> list:
    """Print the rows and write the JSON; returns the rows."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.cost_bench",
        description="The cost engine's speed and exactness on the card: "
                    "batched, streamed, pipelined and cached pricing "
                    "against the per-architecture loop.")
    ap.add_argument("--smoke", action="store_true",
                    help="the small points only")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero where a gate fails")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where pricing runs (default: cuda)")
    ap.add_argument("--out", type=Path, default=OUT_JSON,
                    help=f"the JSON record (default: {OUT_JSON})")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("cost_bench: no CUDA device; pricing runs on the "
                         "card (pass --device cpu to run on the host)")
    smi = card_name_and_power() if args.device == "cuda" else None
    results = rows(smoke=args.smoke, device=args.device)
    for r in results:
        extra = "|".join(f"{k}={v}" for k, v in r.items()
                         if k not in ("workload",))
        us = round(r.get("cost_many_s", r.get("stream_s", 0.0)) * 1e6, 1)
        print(f"cost_{r['workload']},{us},{extra}", flush=True)
    payload = {"archs": list(ARCH_NAMES), "smoke": args.smoke,
               "device": args.device,
               "nvidia_smi": smi,
               "block_ops": STREAM_BLOCK_OPS,
               "gates": {"batched_speedup": CHECK_SPEEDUP,
                         "pipelined_speedup": PIPELINE_SPEEDUP,
                         "warm_cache_speedup": WARM_CACHE_SPEEDUP,
                         "peak_floor_bytes": PEAK_FLOOR_BYTES,
                         "ops_per_s_floors": {
                             k: {"field": f, "floor": v}
                             for k, (f, v) in OPS_PER_S_FLOORS.items()}},
               "results": results}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(payload, indent=2) + "\n")
    print(f"# wrote {args.out}")
    if args.check:
        failures = check(results)
        if failures:
            for msg in failures:
                print(f"# CHECK FAILED: {msg}", file=sys.stderr)
            raise SystemExit(1)
        print(f"# check OK: batched >= {CHECK_SPEEDUP}x loop, pipelined >= "
              f"{PIPELINE_SPEEDUP}x serial, warm cache >= "
              f"{WARM_CACHE_SPEEDUP}x cold, peaks O(block), floors held, "
              f"all bit-equal")
    return results


if __name__ == "__main__":
    main()
