#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
CUDA card: the quickest proof that the port builds, serves (dense, MoE,
SSM and hybrid models), trains (those and the audio and vision models,
on one device and on a mesh), reproduces the paper's Tables II and III,
dispatches MoE requests, runs the kernel micro-bench and counts a step
exactly against the dry run on the GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught and passed over):

  1. build   — compile every ``src/repro_torch/csrc/*.cu`` with ``nvcc``,
               one compiler per source, all started together, and print
               the build seconds;
  2. kernels — ``banked_gather`` / ``banked_scatter`` and their paired
               entries (``banked_gather_pair`` / ``banked_scatter_pair``:
               two tables, one index vector, one launch) against their
               plain PyTorch versions on the card, bit-equal (tolerance 0:
               the kernels copy bytes), over every bank map, f32 and bf16,
               full and narrow page lines, scatters of 24 (one launch) and
               600 (claim, then copy) indices with duplicates, and a gather
               after a scatter; every C entry launched; a multi-port memory
               (no banked layout) runs the same kernels with one bank;
  3. serve   — full-width llama3.2-1b (random weights from a seeded
               ``torch.Generator``, f32 params, bf16 compute) answers
               4 requests × 64 prompt tokens × 16 new tokens on banked page
               pools (16B, page_len 8); the kernels' launch counts over
               that run must match the path (one paired gather and one
               paired scatter per KV layer and decode step, one paired
               scatter per KV layer for the prefill ingest: 240 and 256),
               all from the paired entries, and no plain version runs; the
               first paged decode step's logits equal the dense-cache
               engine's bit for bit, and a wrong page in one request's page
               table changes that request's logits and no other's; the
               recorded traces against the model-free simulation; then both
               kernels, single and paired, against their plain versions,
               bit-equal, on the serving pools at the path's own shapes
               (the 40-line decode read, the 4-line decode append, the
               32-line prefill ingest);
  4. cost    — the serving traffic priced on the card equals the CPU
               pricing on the 9 paper memories, and the 16B serving pins
               22168 (b8 p64 d64, page_len 8) and 2596 (b4 p16 d8,
               page_len 4) hold;
     schedule — continuous batching (``ServeEngine.run_scheduler``) of the
               same model: the reference CLI's day (8 requests at 1.5 a
               tick, mixed contexts, max_seq 512) on 4 lanes; the paired
               row launches are what the day's events imply (16 gathers a
               decode tick, 16 scatters a decode tick and an admission),
               no plain version runs; the same day with the paired entries
               forced to their plain versions gives equal tokens and
               pools, the scratch page included (tolerance 0); the live
               traffic equals the simulation at 16 KV layers and prices on
               the card as on the CPU, checked and unchecked; the day with
               chunked prefill (2 pages a chunk) likewise, with the
               unchunked day's tokens; the reference's pins (80 ops, 2800
               cycles on 16B, 128 on 4R-2W, 8 ticks) priced on the card,
               and 4R-1W first on the 48-request long day by
               ``us_per_token``; tokens/s, time per decode tick and the
               phase's wall time, beside the card's name and power limit;
     faults  — the same day under a fault plan with one of each
               recoverable kind (bank 7 lost at tick 10, rid 6's page
               corrupted at tick 14 and rebuilt by a re-prefill and 6
               replayed decode steps, a decode step failing twice at tick
               20): tokens equal to the fault-free day's; each migration
               one paired gather and one paired scatter a layer, every
               launch the day's events imply and none of a plain
               version; the same faulted day with the row entries forced
               to their plain versions equal in tokens and all 32 pools
               (tolerance 0); live == sim; the day priced on the card as
               on the CPU on ``16B`` and ``16B!d7``; then ``serve
               --schedule --fault-bank 1 --fault-tick 4 --cost`` through
               its ``main``; the phase's wall time beside the card's name
               and power limit;
     preempt — the schedule phase's day preempted by a ``preempt`` event
               at tick 20 (every lane busy), checkpointed under ``build/``
               and resumed in a second ``run_scheduler`` call: merged
               tokens equal to the healthy day's, the halves' traces
               concatenated equal to the simulation, the halves' paired
               row launches summing to the uninterrupted day's (1136 and
               1264) with no plain call, the restored pools equal to the
               saved ones (tolerance 0); the same with 2-page prefill
               chunks, preempted after a tick that leaves a lane mid
               prefill; a day stopped by a real ``PreemptionGuard``'s
               SIGTERM; the checkpoint's bytes and the save, restore and
               resume times beside the card's name and power limit;
  5. tables  — the paper tables' path through its CLI entry point
               (``repro_torch.bench.paper_tables.main``): Tables II and III
               priced on the card equal the CPU pricing, the 16B pins
               1613 / 5791 / 26087 (transpose) and 64216 (fft4096r4) and
               the reproduction tolerances hold, the VM's ``func_err`` and
               the kernels' ``kernel_err`` are within tolerance, and the
               launches are the path's (3 transposes for Table II, one
               transform launch per Table III workload and no planar
               pass); then both kernels against their plain versions at
               the path's shapes (the N×N f32 inputs for N in 32/64/128,
               bit-equal; every pass of the 4096-point input, rtol = atol
               = 1e-5, and the whole transform, bit-equal to the plain
               passes and within 2e-3·max|X| of the numpy oracle);
     figures — the claimed scatter's workspace and CUDA graphs (two
               graphs on one workspace replayed second first, bit-equal; a
               first or growing claimed scatter inside a capture refused);
               then Table I, Fig 9, the autotuner (all 16 rows), its
               quickstart and the bank-scaling and beyond-paper sweeps
               through their CLI entry points on the card, each section's
               wall time logged with the card's name and power limit: card
               rows == CPU rows, the Table I / Fig 9 pins, the six paper
               winners and two serving expectations, hillclimb never
               pricing more points than exhaustive; the path launches no
               kernel (its time is the cost engine's pricing);
     cost_bench — the cost-engine benchmark
               (``repro_torch.bench.cost_bench``) on the card: its CLI
               with ``--smoke --check``, then the full priced cases, the
               full million-op stream and the 4096² construction, each
               held to the reference's gates and 16B pins
               (``BENCH_cost.json``: 1613 ... 34701703); the full
               registry of 14 memories (two-level points included) priced
               on the card equals the CPU pricing on every case's trace
               and a random masked trace; the path launches no kernel;
     serving_bench — the serving benchmark
               (``repro_torch.bench.serving_bench``) through its ``main``
               on the card: the full grid with ``--check`` (its live
               check's paired row launches counted), ``--chaos --smoke
               --check`` and ``--smoke``, every row, the ranking report
               and the chaos row equal to the host's pricing, every pin
               and gate held; then the two serving examples
               (``paged_kv_serving``, its prices and picks equal to the
               host's, and ``serve_lm``) through their ``main``;
     model_traffic — the model-traffic bench
               (``repro_torch.bench.model_traffic_bench``) through its
               ``main`` with ``--check`` on the card: one decode step of
               llama3.2-1b, mixtral-8x22b and jamba-v0.1-52b at their
               published configs priced on the nine paper memories, each
               section's wall time; every row and the ranking equal to the
               host's pricing, the pins (a whole llama step won by 16B,
               ``attn_decode`` alone by 4R-1W, the flip), the whole-step
               winners (mixtral 16B, jamba 16B-offset), the streamed
               mixtral step's host peak (numpy plus the engine's staging)
               at most half its dense matrix, its op count, peak and
               price time printed; no kernel launched;
  6. sweep   — the transpose over (128, 128), (256, 512), (512, 128) and
               (32, 32) × f32/bf16/int32, bit-equal, the FFT passes
               (4096, 0/3/5), (1024, 2) at the reference tests' tolerance,
               and whole transforms n = 256, 1024, 4096 (batch 2) and n =
               4, 16, 64, 16384, 65536 at batches 1, 3 and 1024, each
               bit-equal to the plain passes, within 2e-3·max|X| of the
               oracle and in transform_plan(n) + 1 launches;
  7. controllers — ``conflict_popcount`` and ``carry_arbiter`` against
               their plain versions, bit-equal and one launch a call: popcount
               over n_ops 8/256/1024 x B 4/8/16, ids outside [0, B) (negative
               ones too), B = 32, 12 and 6, (8, 12) and (8, 40) lane
               counts and rows off 16-byte alignment; the arbiter at (8, 16),
               (128, 16), (256, 8) and (384, 6), the bank-0 drain, 32-bit
               words that do not drain, int32 words, int64 words with
               high bits set and negative words, and rows of more than
               32 KB of grants (B = 300 and 4100, written in 32 KB chunks);
               an arbiter call on int64 and on int32 words runs one CUDA
               kernel in all (torch.profiler);
  8. dispatch — ``moe_dispatch_positions`` against its plain version,
               bit-equal, with each call's launches counted (one a pass of
               up to 1024 experts): the CPU tests' cases (the reference
               tests' sweep, the block boundary, R = 300, E = 1, 256, 3000
               and 0, ids outside [0, E), capacity 0 and above R), 2^24
               requests at E = 16 and E = 128 (int32 and int64 ids), and a
               call captured in a CUDA graph, replayed 5 times with other
               calls in between, and two graphs on one stream's workspace
               replayed second first;
  9. bench   — the kernel micro-bench through its CLI entry point
               (``repro_torch.bench.kernel_bench.main``) on the card: the
               six rows in the reference's order, each with err 0, each
               row's kernel launched (the controllers and the dispatch one
               launch a call: 312 each);
 10. times   — the row kernels at the serving shapes, single and paired,
               beside ``index_select`` / ``index_copy_`` and the byte
               bound, and where a paired call's host time goes;
     row_times — both row kernels where bytes rule (16384 lines of 4096
               bf16 from a 32768-page 16B pool), single and paired, held
               bit-equal first; the scatter with a quarter of its indices
               duplicated beside ``index_copy_`` on distinct indices, and
               at N = 1024 / 4096 / 16384 (device time at most 1.5x
               proportional to N); the designs tried (a warp's row chunk;
               one launch against claim-and-copy at small N);
     table_times — the transpose (8192 x 8192 f32) and the FFT
               transform (1024 x 4096 in one launch, 64 x 65536 in three,
               each launch's device time by torch.profiler; the planar pass
               0 and 5 alone) beside their byte bounds, plain versions and
               library calls;
     controller_times — the popcount at 4096 and 2^20 ops and the arbiter
               at 1024 and 2^18 ops (B = 16) beside their bounds and plain
               versions (no library call computes either); the arbiter's
               wrapper on int64 words against the function's bound (4
               bytes in, 64 out a word) and its int64 contract's (8 in,
               128 out), and the kernel alone on 32-bit words;
 11. dispatch_times — the dispatch kernel at the bench's shape (8192
               requests, E = 16) and at 2^24 requests (E = 16 and 128)
               beside its byte bound and plain version (no library call
               computes it), and the device time of its one launch;
     quickstart — ``repro_torch.examples.quickstart`` through its ``main``
               on the card: its lines and values equal its host run;
               section 3's gather one launch of ``gather_rows`` (by the
               launch counters and by ``torch.profiler``), bit-equal to
               its plain version; its launch joins the gather's count in
               the kernels line;
 12. profile — ``torch.profiler`` over a short generation: device busy
               share and the ops that take the time;
 13. analysis — the analysis layer and its neighbours on the serving
               engine: one more generation of the ``serve`` point through
               the paired row kernels (the ``serve`` phase's launches and
               tokens), its recorded stream valid under the trace
               contract on 16B; each decode step's ``step_trace`` through
               ``tune.online(engine, window=8)`` on the card and through
               a host tuner (``device="cpu"``), the ``recommend()`` dicts
               equal at every step and the last step's full rebuild equal
               to its incremental re-price; the symbolic prover against
               the card's ``cost_many`` (``cross_check``) over the
               analysis CLI's 13 memories on whole decode steps of
               llama3.2-1b and jamba-v0.1-52b at full width (batch 4,
               prompt 64) and on Tables II and III (transpose 32, 64,
               128; FFT 4096 at radix 4, 8, 16), the two headline facts
               re-proved; the analysis CLI with no arguments (lint of
               ``src``, prove and check on the card); and the paged
               cache's plain-torch oracle (``append_token`` /
               ``gather_kv``) against ``gather_pages`` / ``scatter_pages``
               on llama3.2-1b's KV shape, bit-equal (those check launches
               stand apart from the path's in the kernels line); gemma2's
               smoke config with ``embed_scale`` served in float32 on the
               card and the host, paged and dense, tokens equal; host and
               card times of each beside the card's name and power limit;
 14. train   — training (``repro_torch.launch.train``, the ``Trainer``),
               after the serving engine is freed: the CLI's default run at
               full width and depth (llama3.2-1b, 4 steps of 16 x 64,
               dense attention; finite losses, the WSD warmup's lr, the
               loss falling); a ``Trainer`` with the ``RunConfig``
               defaults (remat "full", attention "auto") at ``train_4k``'s
               sequence 4096, batch cut from 256 to 2, 2 steps through
               blocked flash attention (its calls counted); from that
               state one layer's attention and the loss, flash against
               dense at bf16 tolerances; the smoke config's resumed run
               against its straight run (rtol 1e-5, under deterministic
               algorithms; the default algorithms' difference printed);
               one float32 step on the card against the host; each step's
               time, tokens/s and peak device memory beside the card's
               name and power limit; no kernel of the seven launched;
 15. families — serving the MoE, SSM and hybrid families, after every
               earlier model is freed: jamba-v0.1-52b at full width cut to
               one superblock (8 layers: 7 Mamba, 1 attention, MoE on 4)
               and falcon-mamba-7b at full width and depth (64 Mamba
               layers), random f32 weights from seed 0, bf16 compute, 4
               requests x 64 prompt + 16 new tokens on 8-token pages of a
               16B pool: peak device memory, prefill time, decode-step
               median and max, tokens/s and one profiled decode step,
               beside the card's name and power limit; jamba's paired row
               launches (15 gathers, 16 scatters) and falcon's none, no
               plain call; jamba's generation with the row entries forced
               to their plain versions equal in tokens and every decode
               state leaf (tolerance 0); falcon's layer 0 in float32, the
               chunked scan against 64 recurrent steps at the reference
               test's tolerance; jamba's first MoE layer's router stream
               through the dispatch kernel, bit-equal to the registry's
               ``ref``; the four families' smoke configs in float32, card
               against host: tokens equal, logits within 1e-5 of the
               largest;
 16. train_families — training the MoE, SSM, hybrid and frontend
               families, after every earlier model is freed (and freeing
               its own): the train CLI (``main``) at full width of
               phi3.5-moe-42b-a6.6b cut to 2 of 32 layers (remat none),
               falcon-mamba-7b cut to 24 of 64 (remat "full": its scan
               keeps about 7.4 GB a layer for the backward) and
               musicgen-medium whole (256 audio frames ahead of 64
               tokens), 4 steps of 16 x 64 each, the first apart and the
               last under ``torch.profiler``: finite losses, gradient
               norms above 0, the aux above 0 exactly for the MoE point,
               no kernel of the seven launched on the path; each step's
               time, tokens/s, 6·N_active·positions as a share of the
               bf16 peak and the peak device memory beside the card's
               name and power limit; the six non-dense smoke configs'
               float32 step, card against host (loss rtol 1e-5, aux 1e-6,
               grad_norm rtol 1e-4, parameters and moments rtol 1e-4 /
               atol 1e-6); falcon's layer 0 in float32, the gradients to
               ``in_proj`` and ``A_log`` through the scan against 64
               recurrent steps (within 1e-4 of the largest), and the
               bytes one layer keeps for its backward; phi3.5-moe's first
               MoE layer's router stream in a training forward through
               the dispatch kernel, bit-equal to the registry's ``ref``;
 17. mesh    — meshes and collectives on a one-rank NCCL group:
               ``make_current_mesh()`` is (1, 1); the ``Trainer`` on it
               trains llama3.2-1b at full width, 3 steps of 16 x 64, with
               the one-device ``Trainer``'s losses; the smoke config
               checkpointed on the mesh and restored by
               ``elastic_restore`` onto a fresh (1, 1) mesh; ``moe_a2a``
               at full width of phi3.5-moe against ``moe_gshard``; a
               one-stage ``pipelined`` against its serial stage;
               ``prefill`` and 8 greedy ``decode_step``s through the mesh
               path at full width (llama3.2-1b whole, jamba cut to one
               superblock, bf16 parameters), bit-equal to one device's
               and at its peak memory; step times, peak memory and the
               wall time beside the card's name and power limit;
 18. dryrun  — the compile-only accounting: llama3.2-1b whole at the
               train CLI's step (16 x 64, remat none) dry-run on a (1, 1)
               stand-in and run for real on the card under the same
               counting: FLOPs and bytes equal exactly, the argument
               bytes equal the ``TrainState`` and batch's; the predicted
               peak and the H100 roofline terms printed beside the
               measured peak and step time; the reference's three
               end-to-end cells at full config on the 256-card stand-in
               through the dry-run CLI (three subprocesses, started with
               the script so that their host work runs beside the other
               phases), each cell's trace seconds and host cost per op,
               FLOPs per device, memory, collectives by kind, dominant
               term and whether it fits 80 GB (an inference cell traces
               the port's mesh step, beside the all-gather bytes of the
               modelled step it replaces); a llama3.2-1b decode step (4 x 4096) counted
               against a real ``decode_step`` on the card the same way;
               ``launch.summarize`` and the driver's ``table1`` and
               ``roofline`` sections over their artifacts.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PROMPT, NEW, BATCH, PAGE_LEN = 64, 16, 4, 8
MAX_SEQ = PROMPT + NEW         # a whole number of pages: paged and dense
                               # attention then run the same shapes


def log(msg: str) -> None:
    print(msg, flush=True)


#: the serving paths past ``serve`` that run the row kernels
ROW_PATHS = ("schedule", "faults", "preempt", "serving_bench", "analysis",
             "families")

LIBRARIES = ("banked_rows", "banked_transpose", "fft_stage", "controllers",
             "moe_dispatch")


def phase_build() -> dict:
    """Every source built at once, one ``nvcc`` each."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import cuda_lib

    def build(name: str) -> float:
        t0 = time.perf_counter()
        cuda_lib.library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        secs = dict(zip(LIBRARIES, pool.map(build, LIBRARIES)))
    wall = time.perf_counter() - t0
    for name in LIBRARIES:
        text = cuda_lib.build_log(name)
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in text.splitlines() if "registers" in line})
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")]
        log(f"[build] csrc/{name}.cu: {secs[name]:.2f} s; ptxas: {regs} "
            f"registers per thread over the kernels' instances; spills: "
            f"{spills or 'none'}")
    log(f"[build] {len(LIBRARIES)} sources in parallel in {wall:.2f} s")
    return {"build_s": wall, "per_source_s": secs}


def _row_cases_equal(name, what, pairs) -> float:
    """(kernel, plain) result pairs, bit-equal; returns the max |diff|."""
    import torch
    torch.cuda.synchronize()
    e = max((g.float() - w.float()).abs().max().item() if g.numel() else 0.0
            for g, w in pairs)
    if not all(torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{name} != plain at {what} (err {e})")
    return e


def phase_kernels() -> dict:
    import torch

    from repro_torch.core import arch as A
    from repro_torch.kernels.banked_gather.ops import (GATHERS,
                                                       banked_gather,
                                                       banked_gather_pair,
                                                       banked_gather_plain)
    from repro_torch.kernels.banked_scatter.ops import (SCATTERS,
                                                        banked_scatter,
                                                        banked_scatter_pair,
                                                        banked_scatter_plain)
    archs = ["16B", "16B-offset", "16B-offset-s2", "16B-xor", "16B-fold",
             "8B", "8B-offset", "8B-offset-s2", "8B-xor", "8B-fold",
             "12B", "6B-offset"]
    rng = np.random.default_rng(0)
    err = {"banked_gather": 0.0, "banked_scatter": 0.0}
    cases = 0
    GATHERS.launches = SCATTERS.launches = 0
    for name in archs:
        lay = A.get(name).layout
        args = (lay.n_banks, lay.mapping, lay.shift)
        v = lay.n_banks * 48
        for dtype in (torch.float32, torch.bfloat16):
            for d in (4096, 1024, 36):
                what = f"{name} {dtype} D={d}"
                table, table2 = (torch.randn((v, d), device="cuda").to(dtype)
                                 for _ in range(2))
                idx = torch.as_tensor(rng.integers(0, v, 40),
                                      device="cuda")
                pair = banked_gather_pair(table, table2, idx, *args)
                err["banked_gather"] = max(err["banked_gather"],
                                           _row_cases_equal(
                    "banked_gather", what, [
                        (banked_gather(table, idx, *args),
                         banked_gather_plain(table, idx, *args)),
                        (pair[0], banked_gather_plain(table, idx, *args)),
                        (pair[1], banked_gather_plain(table2, idx, *args))]))
                # scatter with duplicates: every third index repeats one; 24
                # indices take the one-launch path, 600 the claimed one
                for n in (24, 600):
                    sidx = torch.as_tensor(rng.integers(0, v, n),
                                           device="cuda")
                    sidx[::3] = sidx[1]
                    upd, upd2 = (torch.randn((n, d), device="cuda").to(dtype)
                                 for _ in range(2))
                    t_k = banked_scatter(table.clone(), sidx, upd, *args)
                    t_p = banked_scatter_plain(table.clone(), sidx, upd,
                                               *args)
                    p_k = banked_scatter_pair(table.clone(), table2.clone(),
                                              sidx, upd, upd2, *args)
                    p_p = banked_scatter_plain(table2.clone(), sidx, upd2,
                                               *args)
                    err["banked_scatter"] = max(
                        err["banked_scatter"], _row_cases_equal(
                            "banked_scatter", f"{what} N={n}",
                            [(t_k, t_p), (p_k[0], t_p), (p_k[1], p_p)]))
                    _row_cases_equal("banked_gather", f"{what} after the "
                                     f"N={n} scatter", [
                                         (banked_gather(t_k, sidx, *args),
                                          banked_gather_plain(t_p, sidx,
                                                              *args))])
                cases += 1
    entries = {**GATHERS.by_entry(), **SCATTERS.by_entry()}
    log(f"[kernels] {cases} cases, single and paired, bit-equal to the plain "
        f"versions ({len(archs)} layouts x f32/bf16 x D in 4096/1024/36; "
        f"scatters of 24 and 600 indices with duplicates); launches by "
        f"entry: {entries}")
    if not all(entries.values()):
        raise AssertionError(f"an entry never launched: {entries}")

    # a multi-port memory has no banked layout: the registry runs the same
    # kernels with one bank (the identity map), never the plain version
    from repro_torch import kernels as K
    table = torch.randn((96, 4096), device="cuda").to(torch.bfloat16)
    idx = torch.as_tensor(rng.integers(0, 96, 40), device="cuda")
    idx[::3] = idx[1]
    upd = torch.randn((40, 4096), device="cuda").to(torch.bfloat16)
    g0, s0 = GATHERS.launches, SCATTERS.launches
    got = K.get("banked_gather").run("4R-1W", table, idx)
    new = K.get("banked_scatter").run("4R-1W", table, idx, upd)
    torch.cuda.synchronize()
    ran = (GATHERS.launches - g0, SCATTERS.launches - s0)
    same = (torch.equal(got, table[idx]) and torch.equal(
        new, banked_scatter_plain(table.clone(), idx, upd, 1, "lsb")))
    log(f"[kernels] 4R-1W (no banked layout) through the registry: "
        f"launches {ran}, bit-equal to plain: {same}")
    if ran != (1, 1) or not same:
        raise AssertionError("the multi-port route missed the kernels")
    return {"max_abs_err": err, "cases": cases, "entries": entries}


def _counted_path(tag: str, run, want) -> tuple:
    """Drive a main path once (``run()``) with the row kernels' launch
    counts set to 0 and every call of a plain row version counted, and
    time it on the host to the end of its device work.  ``want(result)``
    gives the launches the run's events imply: each must have been made
    through the paired entry, and no plain version may have run.  Returns
    (result, seconds, launches, launches by entry)."""
    import torch

    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels.banked_scatter import ops as S

    # on CUDA tensors the wrappers must launch their kernels, never these
    plain_calls = {"banked_gather_plain": 0, "banked_scatter_plain": 0}
    originals = {}
    for mod, name in ((G, "banked_gather_plain"), (S, "banked_scatter_plain")):
        fn = originals[mod, name] = getattr(mod, name)

        def call(*args, _fn=fn, _name=name, **kw):
            plain_calls[_name] += 1
            return _fn(*args, **kw)
        setattr(mod, name, call)
    G.GATHERS.launches = S.SCATTERS.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    launches = {"banked_gather": G.GATHERS.launches,
                "banked_scatter": S.SCATTERS.launches}
    entries = {"banked_gather": G.GATHERS.by_entry(),
               "banked_scatter": S.SCATTERS.by_entry()}
    want = want(result)
    log(f"[{tag}] launches on the path: {launches} (expected {want}); by "
        f"entry: {entries}; plain versions called: {plain_calls}")
    if launches != want:
        raise AssertionError(f"[{tag}] launch counts {launches} != {want}")
    if (entries["banked_gather"]["banked_gather_pair_launch"]
            != want["banked_gather"]
            or entries["banked_scatter"]["banked_scatter_pair_launch"]
            != want["banked_scatter"] or any(plain_calls.values())):
        raise AssertionError(f"[{tag}] the path left the paired kernels: "
                             f"{entries}, plain calls {plain_calls}")
    return result, secs, launches, entries


def phase_serve() -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import init_tree, model_specs
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kvcache import simulate_serving_stream

    cfg = get_config("llama3.2-1b")
    rc = RunConfig(remat="none", attn_impl="dense")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_tree(model_specs(cfg), gen, device="cuda")
    engine = ServeEngine(cfg, rc, params, max_batch=BATCH, max_seq=MAX_SEQ,
                         mem_arch="16B", page_len=PAGE_LEN, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (BATCH, PROMPT))
    engine.generate(prompts, max_new_tokens=2)       # warm-up (cuBLAS etc.)

    n_kv, steps = engine.n_kv_layers, NEW - 1
    # one launch per KV layer for its K and V pools: a gather and an
    # append per decode step, one ingest per layer after the prefill
    res, secs, launches, entries = _counted_path(
        "serve", lambda: engine.generate(prompts, max_new_tokens=NEW),
        lambda _: {"banked_gather": n_kv * steps,
                   "banked_scatter": n_kv * steps + n_kv})
    log(f"[serve] llama3.2-1b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}): {BATCH} requests x {PROMPT} prompt + {NEW} new "
        f"tokens in {secs:.3f} s = {BATCH * NEW / secs:.1f} tokens/s "
        f"(prefill included)")
    tokens = res.tokens
    if tokens.shape != (BATCH, NEW) or tokens.min() < 0 or (
            tokens.max() >= cfg.vocab_size):
        raise AssertionError(f"bad tokens {tokens.shape} "
                             f"[{tokens.min()}, {tokens.max()}]")
    log(f"[serve] req0 tokens: {tokens[0].tolist()}")

    # first paged decode step vs the dense-cache engine, same inputs
    with torch.inference_mode():
        toks = torch.as_tensor(prompts, device="cuda")
        logits0, cache = T.prefill(cfg, rc, params, toks)
        tok = logits0[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
        pools, pages = engine._ingest_prefill(cache, PROMPT, BATCH)
        lp, _, _ = engine._paged_step(params, tok, pools, pages, PROMPT)
        dense = ServeEngine(cfg, rc, params, max_batch=BATCH,
                            max_seq=MAX_SEQ, kv_mode="dense", device="cuda")
        ld, _ = T.decode_step(cfg, rc, params, tok,
                              dense._pad_cache(cache, PROMPT),
                              torch.tensor(PROMPT, device="cuda"))
        # a wrong page: request 0's first page table entry names request
        # 1's first page; the pools are the ones the step above used
        bad = pages._replace(page_table=pages.page_table.clone())
        bad.page_table[0, 0] = pages.page_table[1, 0]
        lb, _, _ = engine._paged_step(params, tok, pools, bad, PROMPT)
        lp, ld, lb = (x[..., :cfg.vocab_size].float() for x in (lp, ld, lb))
        if not all(torch.isfinite(x).all() for x in (lp, ld, lb)):
            raise AssertionError("non-finite logits")
        logit_err = (lp - ld).abs().max().item()
        scale = ld.abs().max().item()
        wrong = (lb[0] - lp[0]).abs().max().item()
        others_same = torch.equal(lb[1:], lp[1:])
    # tolerance 0: at MAX_SEQ a whole number of pages, the paged and dense
    # steps run the same einsums on the same shapes and the same values,
    # so any difference is a wrong row read or written
    log(f"[serve] first decode step logits, paged vs dense: max |diff| "
        f"{logit_err:.6g} (max |logit| {scale:.6g}, tolerance 0)")
    if logit_err != 0:
        raise AssertionError("paged logits disagree with the dense cache")
    log(f"[serve] one wrong page in request 0's table: its logits move by "
        f"up to {wrong:.6g} ({wrong / scale:.3g} of max |logit|); the other "
        f"requests' logits unchanged: {others_same}")
    if wrong == 0 or not others_same:
        raise AssertionError("a wrong page does not show in the logits")

    # the recorded traffic == the model-free simulation of the same point
    sim = simulate_serving_stream("16B", batch=BATCH, prompt_len=PROMPT,
                                  decode_steps=steps, page_len=PAGE_LEN,
                                  n_kv_layers=n_kv, max_seq=MAX_SEQ,
                                  device="cuda")
    sim_full = sim.materialize()
    full = engine.serving_trace()
    step, sim_step = engine.step_trace(), list(sim)[-1]
    same = all(np.array_equal(getattr(a, f), getattr(b, f))
               for a, b in ((full, sim_full), (step, sim_step))
               for f in ("addrs", "kinds", "mask"))
    log(f"[serve] traces: step {step.n_ops} ops, generation {full.n_ops} "
        f"ops; equal to simulate_serving_trace: {same}")
    if not same:
        raise AssertionError("live trace != simulated trace")
    return {"engine": engine, "launches": launches, "entries": entries,
            "tokens": tokens.tolist(),
            "tokens_per_s": BATCH * NEW / secs, "generate_s": secs,
            "logit_err": logit_err, "logit_scale": scale,
            "wrong_page_logit_change": wrong,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_cost(engine) -> dict:
    from repro_torch.core.arch import PAPER_ARCHITECTURES
    from repro_torch.core.cost_engine import cost_many
    from repro_torch.serving.kvcache import simulate_serving_trace

    on_card = engine.serving_cost(archs=PAPER_ARCHITECTURES)
    on_cpu = cost_many(PAPER_ARCHITECTURES, engine.serving_stream(),
                       device="cpu")
    if on_card != on_cpu:
        raise AssertionError(f"card pricing {on_card} != CPU {on_cpu}")
    totals = {a.name: c.total_cycles
              for a, c in zip(PAPER_ARCHITECTURES, on_card)}
    log(f"[cost] live serving traffic, card == CPU on 9 memories: {totals}")
    pins = {}
    for key, (b, p, d, pl), want in (("serve_b8_p64_d64", (8, 64, 64, 8),
                                      22168),
                                     ("serve_b4_p16_d8", (4, 16, 8, 4),
                                      2596)):
        trace = simulate_serving_trace("16B", batch=b, prompt_len=p,
                                       decode_steps=d, page_len=pl,
                                       n_kv_layers=2, device="cuda")
        got = cost_many(["16B"], trace, device="cuda")[0].total_cycles
        log(f"[cost] {key} on 16B, priced on the card: {got} cycles "
            f"(pin {want})")
        if got != want:
            raise AssertionError(f"{key}: {got} != {want}")
        pins[key] = got
    return {"live_total_cycles": totals, "pins": pins}


#: the continuous-batching day: the reference CLI's documented example
#: (8 requests at 1.5 a tick, mixed contexts) on 4 lanes, with a context
#: budget of 512 tokens, so the long jobs' prompts are 256-383 tokens and
#: a ragged read is 4 x 64 page lines a layer
SCHED_REQUESTS, SCHED_RATE, SCHED_MAX_SEQ, SCHED_CHUNK = 8, 1.5, 512, 2
#: the reference tests' pinned small traffic (tests/test_scheduler.py:32),
#: (arrival, prompt_len, max_new)
SCHED_PIN_TRAFFIC = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0),
                     (2, 9, 5), (3, 12, 3))


def _plain_pairs(G, S):
    """The paired row entries as their plain versions (each table once)."""
    def gather_pair(k, v, idx, *args):
        return (G.banked_gather_plain(k, idx, *args),
                G.banked_gather_plain(v, idx, *args))

    def scatter_pair(k, v, idx, ku, vu, *args):
        return (S.banked_scatter_plain(k, idx, ku, *args),
                S.banked_scatter_plain(v, idx, vu, *args))
    return gather_pair, scatter_pair


def phase_schedule(engine, smi: str) -> dict:
    """Continuous batching (``ServeEngine.run_scheduler``) of full-width
    llama3.2-1b on the card: a seeded 8-request day through the paired row
    kernels (launches as the day's events imply, no plain call), the same
    day with the row entries forced to their plain versions (tokens and
    every pool equal, tolerance 0), the live traffic against the
    simulation and priced on the card against the CPU (checked and
    unchecked), the day with chunked prefill, and the reference's pins."""
    import torch

    from repro_torch import tune
    from repro_torch.bench import scheduler_workload
    from repro_torch.core.arch import PAPER_ARCHITECTURES
    from repro_torch.core.cost_engine import cost_many
    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels.banked_scatter import ops as S
    from repro_torch.serving import kvcache as KV
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import (Request, Scheduler,
                                               scheduler_pool_config,
                                               simulate_scheduler_stream,
                                               synthesize_requests)
    t_phase = time.perf_counter()
    cfg = engine.cfg
    eng = ServeEngine(cfg, engine.rc, engine.params, max_batch=BATCH,
                      max_seq=SCHED_MAX_SEQ, mem_arch="16B",
                      page_len=PAGE_LEN, device=engine.device)
    reqs = synthesize_requests(SCHED_REQUESTS, arrival_rate=SCHED_RATE,
                               context_dist="mixed", max_seq=SCHED_MAX_SEQ,
                               seed=0, vocab_size=cfg.vocab_size)
    n_kv = eng.n_kv_layers
    sim_kw = dict(n_lanes=BATCH, max_seq=SCHED_MAX_SEQ, page_len=PAGE_LEN,
                  n_kv_layers=n_kv)

    # the counted run, each decode step also timed on the host to the end
    # of its device work
    step_s: list = []
    step = eng._scheduler_step

    def timed_step(*args):
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out
    eng._scheduler_step = timed_step
    try:
        # one paired launch a KV layer: a gather and an append per decode
        # tick, one ingest scatter per admission
        res, secs, launches, entries = _counted_path(
            "schedule", lambda: eng.run_scheduler(reqs),
            lambda r: {"banked_gather": n_kv * r.stats["decode_ticks"],
                       "banked_scatter": n_kv * (r.stats["decode_ticks"]
                                                 + len(reqs))})
    finally:
        del eng._scheduler_step
    ticks, decode_ticks = res.ticks, res.stats["decode_ticks"]
    n_tokens = sum(len(v) for v in res.outputs.values())
    log(f"[schedule] {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}), {len(reqs)} requests "
        f"(arrival rate {SCHED_RATE}, mixed contexts, max_seq "
        f"{SCHED_MAX_SEQ}; prompts {sorted(r.prompt_len for r in reqs)}) "
        f"on {BATCH} lanes: {ticks} ticks, {decode_ticks} decode ticks, "
        f"{n_tokens} tokens in {secs:.3f} s = {n_tokens / secs:.1f} "
        f"tokens/s, {secs / decode_ticks * 1e3:.2f} ms per decode tick "
        f"(prefills included); a decode step alone: median "
        f"{np.median(step_s) * 1e3:.2f} ms, max {max(step_s) * 1e3:.2f} ms "
        f"({smi})")
    for r in reqs:
        out = res.outputs[r.rid]
        if out.shape != (r.max_new_tokens,) or (out.size and (
                out.min() < 0 or out.max() >= cfg.vocab_size)):
            raise AssertionError(f"request {r.rid}: bad tokens {out}")
    pools = eng.last_pools
    live = eng.scheduler_stream()

    # the same day with the paired entries forced to their plain versions
    kernels = KV.banked_gather_pair, KV.banked_scatter_pair
    KV.banked_gather_pair, KV.banked_scatter_pair = _plain_pairs(G, S)
    G.GATHERS.launches = S.SCATTERS.launches = 0
    try:
        plain = eng.run_scheduler(reqs)
    finally:
        KV.banked_gather_pair, KV.banked_scatter_pair = kernels
    plain_launches = G.GATHERS.launches + S.SCATTERS.launches
    torch.cuda.synchronize()
    same_tokens = all(np.array_equal(res.outputs[k], plain.outputs[k])
                      for k in res.outputs) and (
        sorted(res.outputs) == sorted(plain.outputs))
    pool_err = max((a[h].float() - b[h].float()).abs().max().item()
                   for a, b in zip(pools.values(),
                                   eng.last_pools.values())
                   for h in ("k", "v"))
    same_pools = all(torch.equal(a[h], b[h])
                     for a, b in zip(pools.values(), eng.last_pools.values())
                     for h in ("k", "v"))
    log(f"[schedule] the day with the row entries forced to their plain "
        f"versions ({plain_launches} kernel launches): tokens equal "
        f"{same_tokens}, all {2 * len(pools)} pools (the scratch page "
        f"included) equal {same_pools}, max |diff| {pool_err} (tolerance "
        f"0)")
    if plain_launches or not same_tokens or not same_pools:
        raise AssertionError("the kernels' day differs from the plain day")

    # the live traffic == the simulation; priced on the card == CPU
    live_t = live.materialize()
    sim = simulate_scheduler_stream(eng.mem_arch, reqs, **sim_kw)
    sim_t = sim.materialize()
    live_eq = all(np.array_equal(getattr(live_t, f), getattr(sim_t, f))
                  for f in ("addrs", "kinds", "instr", "mask"))
    archs = list(PAPER_ARCHITECTURES)
    on_card = cost_many(archs, live, device="cuda", checked=True)
    if not (on_card == cost_many(archs, live, device="cuda", checked=False)
            == cost_many(archs, sim, device="cpu", checked=True)
            == cost_many(archs, live, device="cpu", checked=False)):
        raise AssertionError("the day's pricing differs: card / CPU, "
                             "checked / unchecked")
    totals = {a.name: c.total_cycles for a, c in zip(archs, on_card)}
    log(f"[schedule] live traffic: {live_t.n_ops} ops, equal to "
        f"simulate_scheduler_stream at {n_kv} KV layers: {live_eq}; priced "
        f"on the card == CPU, checked == unchecked: {totals}")
    if not live_eq:
        raise AssertionError("live scheduler trace != simulated trace")

    # chunked prefill: live == sim, tokens equal to the unchunked day's
    chunked = eng.run_scheduler(reqs, prefill_chunk_pages=SCHED_CHUNK)
    ch_live = eng.scheduler_stream().materialize()
    ch_sim = simulate_scheduler_stream(
        eng.mem_arch, reqs, prefill_chunk_pages=SCHED_CHUNK,
        **sim_kw).materialize()
    ch_eq = all(np.array_equal(getattr(ch_live, f), getattr(ch_sim, f))
                for f in ("addrs", "kinds", "instr", "mask"))
    ch_tokens = all(np.array_equal(chunked.outputs[k], res.outputs[k])
                    for k in res.outputs)
    log(f"[schedule] chunked prefill ({SCHED_CHUNK} pages a chunk): "
        f"{chunked.ticks} ticks, {chunked.stats['prefill_chunks']} chunks; "
        f"live == sim {ch_eq}; tokens equal to the unchunked day's "
        f"{ch_tokens}")
    if not (ch_eq and ch_tokens):
        raise AssertionError("chunked prefill differs")

    # the reference's pins, priced on the card
    pin_reqs = [Request(rid=i, arrival=a, prompt_len=p, max_new_tokens=m)
                for i, (a, p, m) in enumerate(SCHED_PIN_TRAFFIC)]
    pin_kw = dict(n_lanes=4, max_seq=32, page_len=8, n_kv_layers=2)
    pin = simulate_scheduler_stream("16B", pin_reqs, **pin_kw)
    c16, c4r = cost_many(["16B", "4R-2W"], pin, device="cuda", checked=True)
    pin_sched = Scheduler(scheduler_pool_config("16B", 4, 32, 8),
                          n_lanes=4, max_seq=32, n_kv_layers=2)
    for _ in pin_sched.run(pin_reqs):
        pass
    n_ops = sum(b.n_ops for b in pin.blocks())
    pins = {"ops": n_ops, "16B": c16.total_cycles,
            "4R-2W": c4r.total_cycles, "ticks": pin_sched.now}
    day = tune.search(workload=scheduler_workload(
        n_requests=48, arrival_rate=0.5, context_dist="long", n_lanes=8,
        max_seq=128, n_kv_layers=2, seed=0), objective="us_per_token",
        device="cuda")
    log(f"[schedule] reference pins on the card: {pins} (want ops 80, 16B "
        f"2800, 4R-2W 128, ticks 8); us_per_token winner of the 48-request "
        f"long day: {day[0].arch} ({day[0].objective:.4g} us a token; "
        f"runner-up {day[1].arch} {day[1].objective:.4g})")
    if pins != {"ops": 80, "16B": 2800, "4R-2W": 128, "ticks": 8} or (
            day[0].arch != "4R-1W"):
        raise AssertionError(f"reference pins missed: {pins}, "
                             f"{day[0].arch}")
    wall = time.perf_counter() - t_phase
    log(f"[schedule] phase wall time {wall:.2f} s ({smi})")
    return {"outputs": res.outputs, "launches": launches, "entries": entries,
            "requests": [(r.arrival, r.prompt_len, r.max_new_tokens)
                         for r in reqs],
            "ticks": ticks, "decode_ticks": decode_ticks,
            "tokens": n_tokens, "run_s": secs, "tokens_per_s": n_tokens / secs,
            "s_per_decode_tick": secs / decode_ticks,
            "step_s": step_s, "max_abs_err": pool_err,
            "total_cycles": totals, "chunked_ticks": chunked.ticks,
            "pins": pins, "us_per_token_winner": day[0].arch,
            "wall_s": wall, "nvidia_smi": smi}


#: the faulted day: one of each recoverable fault kind on the schedule
#: phase's day.  At tick 10 bank 7 holds 5 live pages of 3 lanes (the
#: scratch page lives on bank 15); at tick 14 request 6 is resident on
#: lane 1, past its prefill, 6 decode steps in; tick 20 is a decode tick
#: (the fault-free schedule, which the scheduler reproduces on the host)
FAULT_BANK = 7
FAULT_EVENTS = ((10, "bank_offline", {"bank": FAULT_BANK}),
                (14, "page_corrupt", {"rid": 6, "page_idx": 2}),
                (20, "decode_transient", {"failures": 2}))


def phase_faults(engine, healthy: dict, smi: str) -> dict:
    """Serving under recoverable faults on the card: the schedule phase's
    day under a plan with a bank loss, an ECC page corruption and a
    transient decode fault.  Tokens equal to the fault-free day's; the
    migration burst and the recovery through the paired row kernels
    (counted per call, no plain call); the same day through the plain
    versions equal at tolerance 0, pools included; live == sim; the
    faulted day priced on the card as on the CPU on the healthy and the
    degraded memory; the serve CLI with ``--fault-bank``."""
    import contextlib
    import io

    import torch

    from repro_torch.bench.serving_bench import implied_row_launches
    from repro_torch.core.cost_engine import cost_many
    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels.banked_scatter import ops as S
    from repro_torch.launch import serve
    from repro_torch.runtime import FaultEvent, FaultPlan
    from repro_torch.serving import kvcache as KV
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import (simulate_scheduler_stream,
                                               synthesize_requests)
    t_phase = time.perf_counter()
    cfg = engine.cfg
    eng = ServeEngine(cfg, engine.rc, engine.params, max_batch=BATCH,
                      max_seq=SCHED_MAX_SEQ, mem_arch="16B",
                      page_len=PAGE_LEN, device=engine.device)
    reqs = synthesize_requests(SCHED_REQUESTS, arrival_rate=SCHED_RATE,
                               context_dist="mixed", max_seq=SCHED_MAX_SEQ,
                               seed=0, vocab_size=cfg.vocab_size)
    plan = FaultPlan(tuple(FaultEvent(tick=t, kind=k, **kw)
                           for t, k, kw in FAULT_EVENTS))
    n_kv = eng.n_kv_layers

    # each migration and each recovery timed and its launches counted
    bursts: list = []

    def counted(kind, fn, size):
        def call(*args):
            g0, s0 = G.GATHERS.launches, S.SCATTERS.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            bursts.append({"kind": kind, "n": size(*args),
                           "s": time.perf_counter() - t0,
                           "gathers": G.GATHERS.launches - g0,
                           "scatters": S.SCATTERS.launches - s0})
            return out
        return call
    eng._migrate_pages = counted("migrate", eng._migrate_pages,
                                 lambda pools, old, new: len(old))
    eng._recover_page = counted("recover", eng._recover_page,
                                lambda pools, rec, *_: int(rec["steps"]))
    try:
        res, secs, launches, entries = _counted_path(
            "faults", lambda: eng.run_scheduler(reqs, fault_plan=plan),
            lambda _: implied_row_launches(eng.scheduler_stream(), n_kv))
    finally:
        del eng._migrate_pages, eng._recover_page
    f = res.stats["faults"]
    same_tokens = sorted(res.outputs) == sorted(healthy) and all(
        np.array_equal(res.outputs[k], healthy[k]) for k in healthy)
    mig = [b for b in bursts if b["kind"] == "migrate"]
    rec = [b for b in bursts if b["kind"] == "recover"]
    log(f"[faults] {cfg.name} on the schedule phase's day under "
        f"{len(plan)} faults: {res.ticks} ticks, "
        f"{res.stats['decode_ticks']} decode ticks in {secs:.3f} s; faults "
        f"{f}; tokens equal to the fault-free day's: {same_tokens}")
    log(f"[faults] migrations {mig} (want {n_kv} paired gathers and {n_kv} "
        f"paired scatters each); recoveries {rec} (want {n_kv} scatters "
        f"for the re-prefill, {n_kv} gathers and scatters a replayed step)")
    if f != {"migrated_pages": f["migrated_pages"], "recoveries": 1,
             "transients": 2, "preempts": 0, "dead_banks": [FAULT_BANK],
             "degraded": True} or f["migrated_pages"] < 1 or (
            not same_tokens):
        raise AssertionError(f"faulted day: {f}, tokens equal "
                             f"{same_tokens}")
    if [(b["n"], b["gathers"], b["scatters"]) for b in mig] != [
            (f["migrated_pages"], n_kv, n_kv)]:
        raise AssertionError(f"the migration left the paired kernels: {mig}")
    if len(rec) != 1 or rec[0]["n"] < 1 or (
            (rec[0]["gathers"], rec[0]["scatters"])
            != (n_kv * rec[0]["n"], n_kv * (rec[0]["n"] + 1))):
        raise AssertionError(f"the recovery's launches: {rec}")
    pools = eng.last_pools
    live = eng.scheduler_stream()

    # the same faulted day with the paired entries forced to their plain
    # versions
    kernels = KV.banked_gather_pair, KV.banked_scatter_pair
    KV.banked_gather_pair, KV.banked_scatter_pair = _plain_pairs(G, S)
    G.GATHERS.launches = S.SCATTERS.launches = 0
    try:
        plain = eng.run_scheduler(reqs, fault_plan=plan)
    finally:
        KV.banked_gather_pair, KV.banked_scatter_pair = kernels
    plain_launches = G.GATHERS.launches + S.SCATTERS.launches
    torch.cuda.synchronize()
    same_plain = sorted(plain.outputs) == sorted(res.outputs) and all(
        np.array_equal(res.outputs[k], plain.outputs[k])
        for k in res.outputs)
    pool_err = max((a[h].float() - b[h].float()).abs().max().item()
                   for a, b in zip(pools.values(), eng.last_pools.values())
                   for h in ("k", "v"))
    same_pools = all(torch.equal(a[h], b[h])
                     for a, b in zip(pools.values(), eng.last_pools.values())
                     for h in ("k", "v"))
    log(f"[faults] the faulted day with the row entries forced to their "
        f"plain versions ({plain_launches} kernel launches): tokens equal "
        f"{same_plain}, all {2 * len(pools)} pools equal {same_pools}, max "
        f"|diff| {pool_err} (tolerance 0)")
    if plain_launches or not same_plain or not same_pools:
        raise AssertionError("the kernels' faulted day differs from the "
                             "plain day")

    # live == sim; priced on the card == CPU, healthy and degraded
    sim = simulate_scheduler_stream(eng.mem_arch, reqs, n_lanes=BATCH,
                                    max_seq=SCHED_MAX_SEQ, page_len=PAGE_LEN,
                                    n_kv_layers=n_kv, fault_plan=plan)
    live_t, sim_t = live.materialize(), sim.materialize()
    live_eq = all(np.array_equal(getattr(live_t, k), getattr(sim_t, k))
                  for k in ("addrs", "kinds", "instr", "mask"))
    archs = [eng.mem_arch, eng.mem_arch.degrade(f["dead_banks"])]
    on_card = cost_many(archs, live, device="cuda")
    on_cpu = cost_many(archs, sim, device="cpu")
    totals = {a.name: c.total_cycles for a, c in zip(archs, on_card)}
    log(f"[faults] live traffic {live_t.n_ops} ops, equal to "
        f"simulate_scheduler_stream with the plan: {live_eq}; priced on the "
        f"card: {totals}, equal to the CPU: {on_card == on_cpu}")
    if not live_eq or on_card != on_cpu or (
            on_card[1].total_cycles < on_card[0].total_cycles):
        raise AssertionError("faulted live != sim, or card pricing != CPU")

    # the serve CLI with a bank loss, on the card
    out = io.StringIO()
    t_cli = time.perf_counter()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "llama3.2-1b",
                    "--schedule", "--n-requests", "8",
                    "--fault-bank", "1", "--fault-tick", "4", "--cost"])
    cli_s = time.perf_counter() - t_cli
    lines = out.getvalue().splitlines()
    summary = [ln for ln in lines if ln.startswith("faults:")]
    log(f"[faults] serve --schedule --fault-bank 1 --fault-tick 4 --cost: "
        f"{cli_s:.2f} s; {summary}; last row: {lines[-1]!r}")
    if (sum(ln.startswith("req") for ln in lines) != 8 or len(summary) != 1
            or not lines[-1].endswith("(degraded survivors)")):
        raise AssertionError(f"serve --fault-bank printed {lines}")
    wall = time.perf_counter() - t_phase
    log(f"[faults] phase wall time {wall:.2f} s ({smi})")
    return {"launches": launches, "entries": entries, "faults": f,
            "ticks": res.ticks, "decode_ticks": res.stats["decode_ticks"],
            "run_s": secs, "bursts": bursts, "max_abs_err": pool_err,
            "total_cycles": totals, "cli_s": cli_s, "cli_lines": lines,
            "wall_s": wall, "nvidia_smi": smi}


#: the preempted day: the schedule phase's day, preempted at a mid-day
#: tick with all 4 lanes busy (checked by simulation), checkpointed under
#: ``build/`` and resumed in a second call; the chunked day is preempted at
#: the first tick from PREEMPT_TICK on after which a lane is mid-prefill
PREEMPT_TICK = 20


def _preempt_tick_mid_prefill(kv_cfg, reqs, n_kv: int, start: int) -> int:
    """The first tick from ``start`` on after whose physics a lane of the
    chunked day is mid-prefill, found by running the scheduler alone."""
    from repro_torch.serving.scheduler import Scheduler
    sched = Scheduler(kv_cfg, n_lanes=BATCH, max_seq=SCHED_MAX_SEQ,
                      n_kv_layers=n_kv, prefill_chunk_pages=SCHED_CHUNK)
    for ev in sched.run(reqs):
        if ev.tick >= start and sched._prefill_next:
            return ev.tick
    raise AssertionError(f"no lane is mid-prefill after tick {start}")


def phase_preempt(engine, healthy: dict, launches: dict, smi: str) -> dict:
    """Preemption on the card: the schedule phase's day preempted by a
    ``preempt`` event at a tick with every lane busy, checkpointed and
    resumed in a second ``run_scheduler`` call (merged tokens equal to the
    healthy day's; the halves' traces concatenated equal to the
    simulation; the halves' paired row launches summing to the
    uninterrupted day's, no plain call; the pools the resume restores equal
    to the saved ones at tolerance 0); the same with chunked prefill,
    preempted while a lane is mid-prefill; and a day stopped by a real
    ``PreemptionGuard`` whose SIGTERM arrives before the run.  Prints the
    checkpoint's bytes and the save, restore and resume times."""
    import shutil
    import signal
    import tempfile

    import torch

    import repro_torch.checkpoint as CK
    from repro_torch.bench.serving_bench import implied_row_launches
    from repro_torch.core.trace import AddressTrace
    from repro_torch.runtime import FaultEvent, FaultPlan, PreemptionGuard
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import (Scheduler,
                                               simulate_scheduler_stream,
                                               synthesize_requests)
    t_phase = time.perf_counter()
    cfg = engine.cfg
    eng = ServeEngine(cfg, engine.rc, engine.params, max_batch=BATCH,
                      max_seq=SCHED_MAX_SEQ, mem_arch="16B",
                      page_len=PAGE_LEN, device=engine.device)
    reqs = synthesize_requests(SCHED_REQUESTS, arrival_rate=SCHED_RATE,
                               context_dist="mixed", max_seq=SCHED_MAX_SEQ,
                               seed=0, vocab_size=cfg.vocab_size)
    n_kv = eng.n_kv_layers
    sim_kw = dict(n_lanes=BATCH, max_seq=SCHED_MAX_SEQ, page_len=PAGE_LEN,
                  n_kv_layers=n_kv)
    (ROOT / "build").mkdir(exist_ok=True)
    ck_root = Path(tempfile.mkdtemp(prefix="preempt_", dir=ROOT / "build"))

    # the save and the resume's restore, timed to the end of their device
    # work; each restored pool held to the saved one before the resumed
    # half writes into it
    timing: dict = {}
    saved: dict = {}
    save, restore = CK.save_checkpoint, CK.restore_checkpoint

    def timed_save(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(*args, **kw)
        timing["save_s"] = time.perf_counter() - t0
        return path

    def timed_restore(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = restore(*args, **kw)
        torch.cuda.synchronize()
        timing["restore_s"] = time.perf_counter() - t0
        pools = out["pools"]
        timing["restore_err"] = max(
            (pools[k][h].float() - saved[k][h].float()).abs().max().item()
            for k in saved for h in ("k", "v"))
        timing["restore_equal"] = all(
            torch.equal(pools[k][h], saved[k][h])
            for k in saved for h in ("k", "v"))
        return out

    def preempted_day(tag, plan, chunk=None, guard=None):
        """Both halves of one preempted day; returns their results and
        traces, the checkpoint's bytes, and the times."""
        ck = str(ck_root / tag)
        timing.clear()
        saved.clear()
        t0 = time.perf_counter()
        if guard is None:
            part1 = eng.run_scheduler(reqs, fault_plan=plan,
                                      checkpoint_dir=ck,
                                      prefill_chunk_pages=chunk)
        else:
            with PreemptionGuard(signals=(signal.SIGTERM,)) as g:
                signal.raise_signal(signal.SIGTERM)
                part1 = eng.run_scheduler(reqs, guard=g, checkpoint_dir=ck,
                                          prefill_chunk_pages=chunk)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        saved.update(eng.last_pools)
        tr1 = eng.scheduler_stream().materialize()
        t0 = time.perf_counter()
        part2 = eng.run_scheduler(None, fault_plan=plan, resume_from=ck,
                                  prefill_chunk_pages=chunk)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        tr2 = eng.scheduler_stream().materialize()
        ck_bytes = sum(f.stat().st_size
                       for f in Path(part1.checkpoint).iterdir())
        return {"part1": part1, "part2": part2, "tr1": tr1, "tr2": tr2,
                "bytes": ck_bytes, "first_s": first_s, "resume_s": resume_s,
                **timing}

    def held(tag, day, plan, chunk, want_launches, got_launches):
        """The checks of one preempted day."""
        p1, p2 = day["part1"], day["part2"]
        full = simulate_scheduler_stream(
            eng.mem_arch, reqs, fault_plan=plan, prefill_chunk_pages=chunk,
            **sim_kw).materialize()
        cat = AddressTrace.concat(day["tr1"], day["tr2"])
        trace_eq = all(np.array_equal(getattr(cat, f), getattr(full, f))
                       for f in ("addrs", "kinds", "instr", "mask"))
        tokens_eq = sorted(p2.outputs) == sorted(healthy) and all(
            np.array_equal(p2.outputs[k], healthy[k]) for k in healthy)
        log(f"[preempt] {tag}: preempted after tick {p1.ticks - 1} "
            f"({len(p1.outputs)} requests done, checkpoint {day['bytes']} "
            f"bytes), resumed to tick {p2.ticks}; merged tokens equal to "
            f"the healthy day's {tokens_eq}; halves' traces ({len(day['tr1'].addrs)} + "
            f"{len(day['tr2'].addrs)} ops) == simulation {trace_eq}; row "
            f"launches {got_launches} (uninterrupted day {want_launches}); "
            f"restored pools equal {day['restore_equal']} (max |diff| "
            f"{day['restore_err']}); save {day['save_s']:.3f} s, restore "
            f"{day['restore_s']:.3f} s, first half {day['first_s']:.3f} s, "
            f"resumed half {day['resume_s']:.3f} s ({smi})")
        if not (p1.preempted and not p2.preempted and tokens_eq and trace_eq
                and day["restore_equal"] and day["restore_err"] == 0
                and got_launches == want_launches):
            raise AssertionError(f"[preempt] {tag} failed its checks")

    # the day's tick with every lane busy, by simulation
    busy = None
    sched = Scheduler(eng.kv_cfg, n_lanes=BATCH, max_seq=SCHED_MAX_SEQ,
                      n_kv_layers=n_kv)
    for ev in sched.run(reqs):
        if ev.tick == PREEMPT_TICK:
            busy = int((sched.lane_rid >= 0).sum())
    if busy != BATCH:
        raise AssertionError(f"tick {PREEMPT_TICK} has {busy} busy lanes")
    plan = FaultPlan((FaultEvent(tick=PREEMPT_TICK, kind="preempt"),))
    CK.save_checkpoint, CK.restore_checkpoint = timed_save, timed_restore
    try:
        day, secs, got, entries = _counted_path(
            "preempt", lambda: preempted_day("unchunked", plan),
            lambda _: launches)
        held("unchunked", day, plan, None, launches, got)
        ch_tick = _preempt_tick_mid_prefill(eng.kv_cfg, reqs, n_kv,
                                            PREEMPT_TICK)
        ch_plan = FaultPlan((FaultEvent(tick=ch_tick, kind="preempt"),))
        ch_want = implied_row_launches(simulate_scheduler_stream(
            eng.mem_arch, reqs, prefill_chunk_pages=SCHED_CHUNK,
            **sim_kw), n_kv)
        chunked, _, ch_got, ch_entries = _counted_path(
            "preempt chunked", lambda: preempted_day(
                "chunked", ch_plan, chunk=SCHED_CHUNK),
            lambda _: ch_want)
        aux = CK.load_aux(str(ck_root / "chunked"), ch_tick + 1)
        if not aux["sched"]["prefill_next"]:
            raise AssertionError("the chunked day was not mid-prefill")
        held(f"chunked ({SCHED_CHUNK} pages a chunk, tick {ch_tick}, lanes "
             f"mid-prefill {sorted(aux['sched']['prefill_next'])})",
             chunked, ch_plan, SCHED_CHUNK, ch_want, ch_got)
        guarded, _, g_got, g_entries = _counted_path(
            "preempt guard", lambda: preempted_day("guard", None,
                                                   guard=True),
            lambda _: launches)
        held("SIGTERM through a PreemptionGuard", guarded, None, None,
             launches, g_got)
        if guarded["part1"].ticks != 1:
            raise AssertionError("the guard did not stop the first tick")
    finally:
        CK.save_checkpoint, CK.restore_checkpoint = save, restore
        shutil.rmtree(ck_root)
    wall = time.perf_counter() - t_phase
    log(f"[preempt] phase wall time {wall:.2f} s ({smi})")
    days = {"unchunked": day, "chunked": chunked, "guard": guarded}
    # the path's launches: the three preempted and resumed days together
    return {"launches": {k: got[k] + ch_got[k] + g_got[k] for k in got},
            "entries": {k: {e: entries[k][e] + ch_entries[k][e]
                            + g_entries[k][e] for e in entries[k]}
                        for k in entries},
            "launches_by_day": {"unchunked": got, "chunked": ch_got,
                                "guard": g_got},
            "preempt_tick": PREEMPT_TICK, "chunked_tick": ch_tick,
            "days": {k: {f: d[f] for f in ("bytes", "save_s", "restore_s",
                                           "first_s", "resume_s",
                                           "restore_err")}
                     | {"ticks": (d["part1"].ticks, d["part2"].ticks)}
                     for k, d in days.items()},
            "max_abs_err": max(d["restore_err"] for d in days.values()),
            "run_s": secs, "wall_s": wall, "nvidia_smi": smi}


def _serving_inputs(engine) -> dict:
    """The row kernels' inputs at the serve phase's shapes: a layer's K and
    V pools (n_pages x row_width, compute dtype, random contents), the
    batch's page lists (one decode step's gather), each sequence's current
    page (one decode step's append) and the prompt pages (the prefill
    ingest), with K and V update rows for both scatters."""
    import torch
    kv, lay = engine.kv_cfg, engine.mem_arch.layout
    pt = engine.last_pages.page_table
    dtype = getattr(torch, engine.rc.compute_dtype)
    n_pref = -(-PROMPT // PAGE_LEN)
    ids = {"read": pt.clamp(min=0).reshape(-1),
           "append": pt[:, (PROMPT + NEW - 2) // PAGE_LEN].clamp(min=0),
           "ingest": pt[:, :n_pref].clamp(min=0).reshape(-1)}

    def rand(rows):
        return torch.randn((rows, kv.row_width), device="cuda").to(dtype)
    return {"kv": kv, "dtype": dtype, "ids": ids,
            "args": (lay.n_banks, lay.mapping, lay.shift),
            "pool": rand(kv.n_pages), "pool2": rand(kv.n_pages),
            "upd": {k: rand(ids[k].shape[0]) for k in ("append", "ingest")},
            "upd2": {k: rand(ids[k].shape[0]) for k in ("append", "ingest")}}


def phase_path_kernels(engine) -> dict:
    """Both kernels, single and paired, against their plain versions,
    bit-equal, on the serving pools at the shapes the serve phase gave
    them."""
    import torch

    from repro_torch.kernels.banked_gather.ops import (banked_gather,
                                                       banked_gather_pair,
                                                       banked_gather_plain)
    from repro_torch.kernels.banked_scatter.ops import (banked_scatter,
                                                        banked_scatter_pair,
                                                        banked_scatter_plain)
    inp = _serving_inputs(engine)
    pool, pool2, ids, args = inp["pool"], inp["pool2"], inp["ids"], \
        inp["args"]
    err = {"banked_gather": 0.0, "banked_scatter": 0.0}

    def held(name, what, got, want):
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        err[name] = max(err[name], e)
        log(f"[path] {name}, {what}: {tuple(got.shape)} {got.dtype}, "
            f"bit-equal to plain: {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain at {what} (err {e})")

    read = ids["read"]
    held("banked_gather", f"decode read of {read.shape[0]} lines",
         banked_gather(pool, read, *args),
         banked_gather_plain(pool, read, *args))
    for got, p in zip(banked_gather_pair(pool, pool2, read, *args),
                      (pool, pool2)):
        held("banked_gather", f"paired decode read of {read.shape[0]} lines",
             got, banked_gather_plain(p, read, *args))
    for step in ("append", "ingest"):
        upd, upd2 = inp["upd"][step], inp["upd2"][step]
        k = banked_scatter(pool.clone(), ids[step], upd, *args)
        p = banked_scatter_plain(pool.clone(), ids[step], upd, *args)
        held("banked_scatter", f"{step} of {ids[step].shape[0]} lines", k, p)
        pk = banked_scatter_pair(pool.clone(), pool2.clone(), ids[step], upd,
                                 upd2, *args)
        p2 = banked_scatter_plain(pool2.clone(), ids[step], upd2, *args)
        held("banked_scatter", f"paired {step} of {ids[step].shape[0]} lines",
             pk[0], p)
        held("banked_scatter", f"paired {step} of {ids[step].shape[0]} "
             f"lines, V", pk[1], p2)
        held("banked_gather", f"decode read after the {step}",
             banked_gather(k, read, *args),
             banked_gather_plain(p, read, *args))
    return {"max_abs_err": err}


def _host_us(fn, iters: int = 2000) -> float:
    """Host time per call in µs: the host clock over ``iters`` back-to-back
    calls after a warm-up, read before the closing sync (what the host
    spends enqueueing; the device keeps up at these shapes)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def _us(r: dict) -> dict:
    return {k: v * 1e3 for k, v in r.items()
            if k.endswith("ms") and isinstance(v, float)}


def phase_times(engine) -> dict:
    """The row kernels at the serving shapes (one decode step: the 40-line
    read, the 4-line append), single and paired, each beside its byte
    bound, its plain version and the library call (one per table for a
    pair); then where a paired call's host time goes."""
    import torch

    from repro_torch.bench.kernel_bench import bound_ms, timed
    from repro_torch.core.arch import physical_row_of
    from repro_torch.kernels import cuda_lib, registry
    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels.banked_scatter import ops as S
    from repro_torch.serving import kvcache as KV
    inp = _serving_inputs(engine)
    kv, dtype, args = inp["kv"], inp["dtype"], inp["args"]
    pool, pool2 = inp["pool"], inp["pool2"]
    lay = engine.mem_arch.layout
    read, cur = inp["ids"]["read"], inp["ids"]["append"]
    upd, upd2 = inp["upd"]["append"], inp["upd2"]["append"]
    read_phys, cur_phys = (physical_row_of(i, lay.n_banks,
                                           kv.n_pages // lay.n_banks,
                                           lay.mapping, lay.shift)
                           for i in (read, cur))
    row = kv.row_width * pool.element_size()

    def bound(n: int, tables: int) -> tuple:
        # each input read once, each output written once: n rows in and n
        # rows out per table, n int64 indices
        return bound_ms(2 * tables * n * row + 8 * n)

    out = {}
    for name, n, tables, kern, plain, lib in (
            ("banked_gather", read.shape[0], 1,
             lambda: G.banked_gather(pool, read, *args),
             lambda: G.banked_gather_plain(pool, read, *args),
             lambda: torch.index_select(pool, 0, read_phys)),
            ("banked_gather", read.shape[0], 2,
             lambda: G.banked_gather_pair(pool, pool2, read, *args),
             lambda: (G.banked_gather_plain(pool, read, *args),
                      G.banked_gather_plain(pool2, read, *args)),
             lambda: (torch.index_select(pool, 0, read_phys),
                      torch.index_select(pool2, 0, read_phys))),
            ("banked_scatter", cur.shape[0], 1,
             lambda: S.banked_scatter(pool, cur, upd, *args),
             lambda: S.banked_scatter_plain(pool, cur, upd, *args),
             lambda: pool.index_copy_(0, cur_phys, upd)),
            ("banked_scatter", cur.shape[0], 2,
             lambda: S.banked_scatter_pair(pool, pool2, cur, upd, upd2,
                                           *args),
             lambda: (S.banked_scatter_plain(pool, cur, upd, *args),
                      S.banked_scatter_plain(pool2, cur, upd2, *args)),
             lambda: (pool.index_copy_(0, cur_phys, upd),
                      pool2.index_copy_(0, cur_phys, upd2)))):
        r = timed(kern, plain, lib, bound(n, tables), graph_iters=100,
                  iters=200)
        r.update(rows=int(n), tables=tables, row_width=kv.row_width,
                 dtype=str(dtype))
        out[f"{name}_{'pair' if tables == 2 else 'single'}"] = r
        us = _us(r)
        lib_name = ("index_select" if name == "banked_gather"
                    else "index_copy_") + (" x2" if tables == 2 else "")
        log(f"[times] {name} {'paired' if tables == 2 else 'single'}: "
            f"{n} rows x {kv.row_width} {dtype} x {tables} table(s), per "
            f"call from Python: kernel {us['ms']:.2f} us, plain "
            f"{us['plain_ms']:.2f} us, {lib_name} {us['library_ms']:.2f} "
            f"us; device time in a CUDA graph: kernel "
            f"{us['device_ms']:.3f} us, {lib_name} "
            f"{us['library_device_ms']:.3f} us; bound {us['bound_ms']:.3f} "
            f"us (bytes)")

    # where a paired call's host time goes (per call, µs)
    n, v, d = read.shape[0], kv.n_pages, kv.row_width
    rmap = G.map_arg(v, n, *args)
    chunk = G.chunk_bytes(n, row)
    gout = torch.empty((2, n, d), dtype=dtype, device="cuda")
    ptrs = (pool.data_ptr(), pool2.data_ptr(), gout.data_ptr(),
            gout.data_ptr() + n * row, read.data_ptr())
    gather_run = registry.get("banked_gather").run
    scatter_run = registry.get("banked_scatter").run
    arch = engine.mem_arch
    nc = cur.shape[0]
    smap = G.map_arg(v, nc, *args)
    sptrs = (pool.data_ptr(), pool2.data_ptr(), upd.data_ptr(),
             upd2.data_ptr(), cur.data_ptr())
    host = {
        "gather_pair": {
            "kvcache.gather_pages_pair": _host_us(
                lambda: KV.gather_pages_pair(kv, pool, pool2, read)),
            "banked_gather_pair": _host_us(
                lambda: G.banked_gather_pair(pool, pool2, read, *args)),
            "checks": _host_us(lambda: (G.check_rows(pool, read, *args[:2]),
                                        G.check_pair(pool, pool2))),
            "map constants": _host_us(lambda: (G.map_arg(v, n, *args),
                                               G.chunk_bytes(n, row))),
            "torch.empty": _host_us(
                lambda: torch.empty((2, n, d), dtype=dtype, device="cuda")),
            "new_empty": _host_us(lambda: pool.new_empty((2, n, d))),
            "torch.cuda.current_stream()": _host_us(
                lambda: torch.cuda.current_stream().cuda_stream),
            "raw current stream": _host_us(cuda_lib.current_stream),
            "ctypes launch": _host_us(
                lambda: G.GATHER_PAIR(*ptrs, n, row, chunk, rmap)),
            "two registry.run calls (the parent's path)": _host_us(
                lambda: (gather_run(arch, pool, read, table_banked=True),
                         gather_run(arch, pool2, read, table_banked=True))),
        },
        "scatter_pair": {
            "kvcache.scatter_pages_pair": _host_us(
                lambda: KV.scatter_pages_pair(kv, pool, pool2, cur, upd,
                                              upd2)),
            "banked_scatter_pair": _host_us(
                lambda: S.banked_scatter_pair(pool, pool2, cur, upd, upd2,
                                              *args)),
            "checks": _host_us(lambda: (
                G.check_rows(pool, cur, *args[:2]), G.check_pair(pool, pool2),
                S._check_updates(pool, cur, upd),
                S._check_updates(pool2, cur, upd2))),
            "ctypes launch": _host_us(
                lambda: S.SCATTER_PAIR(*sptrs, nc, row,
                                       G.chunk_bytes(nc, row), smap)),
            "two registry.run calls (the parent's path)": _host_us(
                lambda: (scatter_run(arch, pool, cur, upd, table_banked=True),
                         scatter_run(arch, pool2, cur, upd2,
                                     table_banked=True))),
        }}
    for what, split in host.items():
        log(f"[times] host time of a {what} call at the serving shape "
            f"(per call, 2000 calls): " + ", ".join(
                f"{k} {v:.2f} us" for k, v in split.items()))
    out["host_us"] = host
    return out


ROW_POOL_PAGES, ROW_LINES = 32768, 16384   # a 16B pool; 4 requests x 32 K
                                            # tokens of 8-token pages
ROW_WIDTH = 4096                            # one page line of llama3.2-1b
SCATTER_SIZES = (1024, 4096, 16384)


def _quarter_duplicated(ids, gen):
    """ids with a random quarter of its entries replaced by other entries
    of ids (so about a quarter of the updates lose to a later writer)."""
    import torch
    n = ids.shape[0]
    out = ids.clone()
    pick = torch.randperm(n, device=ids.device, generator=gen)[:n // 4]
    out[pick] = ids[torch.randint(0, n, (n // 4,), device=ids.device,
                                  generator=gen)]
    return out


def phase_row_times() -> dict:
    """Both row kernels where bytes rule: 16384 lines of 4096 bf16 (a 32 K
    context of 4 requests, one layer's K) from a 32768-page 16B pool,
    single and paired, held bit-equal to the plain versions first; the
    scatter with a quarter of its indices duplicated, beside index_copy_
    on distinct indices, and at N = 1024 / 4096 / 16384 (time linear in
    N); then the designs tried: the row chunk of a warp, and the one-launch
    against the claimed scatter at small N."""
    import torch

    from repro_torch.bench.kernel_bench import bound_ms, graph_ms, timed
    from repro_torch.core import arch as A
    from repro_torch.core.arch import physical_row_of
    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels.banked_scatter import ops as S
    lay = A.get("16B").layout
    args = (lay.n_banks, lay.mapping, lay.shift)
    gen = torch.Generator(device="cuda").manual_seed(11)
    v, n, d = ROW_POOL_PAGES, ROW_LINES, ROW_WIDTH
    pool, pool2 = (torch.randn((v, d), device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(2))
    row = d * pool.element_size()
    ids = torch.randperm(v, device="cuda", generator=gen)[:n]
    phys = physical_row_of(ids, lay.n_banks, v // lay.n_banks, lay.mapping,
                           lay.shift)
    err = {"banked_gather": 0.0, "banked_scatter": 0.0}
    g1 = G.banked_gather(pool, ids, *args)
    g2 = G.banked_gather_pair(pool, pool2, ids, *args)
    err["banked_gather"] = _row_cases_equal("banked_gather", f"{n} lines", [
        (g1, G.banked_gather_plain(pool, ids, *args)),
        (g2[0], g1), (g2[1], G.banked_gather_plain(pool2, ids, *args))])
    del g1, g2
    out = {}
    out["banked_gather"] = timed(
        lambda: G.banked_gather(pool, ids, *args),
        lambda: G.banked_gather_plain(pool, ids, *args),
        lambda: torch.index_select(pool, 0, phys),
        bound_ms(2 * n * row + 8 * n), graph_iters=20, iters=50)
    out["banked_gather_pair"] = timed(
        lambda: G.banked_gather_pair(pool, pool2, ids, *args),
        lambda: (G.banked_gather_plain(pool, ids, *args),
                 G.banked_gather_plain(pool2, ids, *args)),
        lambda: (torch.index_select(pool, 0, phys),
                 torch.index_select(pool2, 0, phys)),
        bound_ms(4 * n * row + 8 * n), graph_iters=20, iters=50)

    sidx = _quarter_duplicated(ids, gen)
    distinct = int(sidx.unique().numel())
    upd, upd2 = (torch.randn((n, d), device="cuda", generator=gen).to(
        torch.bfloat16) for _ in range(2))
    one = S.banked_scatter(pool.clone(), sidx, upd, *args)
    two = S.banked_scatter_pair(pool.clone(), pool2.clone(), sidx, upd, upd2,
                                *args)
    err["banked_scatter"] = _row_cases_equal(
        "banked_scatter", f"{n} lines, {n - distinct} losing duplicates", [
            (one, S.banked_scatter_plain(pool.clone(), sidx, upd, *args)),
            (two[0], one),
            (two[1], S.banked_scatter_plain(pool2.clone(), sidx, upd2,
                                            *args))])
    del one, two
    # the function's bytes: the indices, and each winning update read once
    # and written once (the losers' rows need not move)
    out["banked_scatter"] = timed(
        lambda: S.banked_scatter(pool, sidx, upd, *args),
        lambda: S.banked_scatter_plain(pool, sidx, upd, *args),
        lambda: pool.index_copy_(0, phys, upd),
        bound_ms(8 * n + 2 * distinct * row), graph_iters=20, iters=50)
    out["banked_scatter_pair"] = timed(
        lambda: S.banked_scatter_pair(pool, pool2, sidx, upd, upd2, *args),
        lambda: (S.banked_scatter_plain(pool, sidx, upd, *args),
                 S.banked_scatter_plain(pool2, sidx, upd2, *args)),
        lambda: (pool.index_copy_(0, phys, upd),
                 pool2.index_copy_(0, phys, upd2)),
        bound_ms(8 * n + 4 * distinct * row), graph_iters=20, iters=50)
    for name, r in out.items():
        us = _us(r)
        lib = ("index_select" if "gather" in name else
               "index_copy_ (distinct indices)") + (
                   " x2" if "pair" in name else "")
        log(f"[row_times] {name} at {n} lines x {d} bf16 from {v} pages: "
            f"per call from Python: kernel {us['ms']:.2f} us, plain "
            f"{us['plain_ms']:.2f} us, {lib} {us['library_ms']:.2f} us; "
            f"device time in a CUDA graph: kernel {us['device_ms']:.3f} us, "
            f"{lib} {us['library_device_ms']:.3f} us; bound "
            f"{us['bound_ms']:.3f} us ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of it")
    out["scatter_distinct_rows"] = distinct

    # time linear in N: the scatter (quarter duplicated) at three sizes
    linear = {}
    for m in SCATTER_SIZES:
        midx = _quarter_duplicated(ids[:m], gen)
        linear[m] = graph_ms(lambda: S.banked_scatter(pool, midx, upd[:m],
                                                      *args), 20)
    base = SCATTER_SIZES[0]
    ratios = {m: (linear[m] / linear[base]) / (m / base) for m in linear}
    log(f"[row_times] banked_scatter device time by N (quarter "
        f"duplicated): " + ", ".join(f"N={m}: {t * 1e3:.3f} us"
                                     for m, t in linear.items())
        + f"; time / N against N={base}: " + ", ".join(
            f"{r:.3f}" for r in ratios.values()) + " (at most 1.5)")
    if max(ratios.values()) > 1.5:
        raise AssertionError(f"scatter time grows faster than N: {linear}")
    out["scatter_by_n_ms"] = linear

    # the designs tried: the row chunk a warp copies (the pair at the
    # serving read's 40 lines, the single gather at 16384 lines), and the
    # one-launch scatter against the claimed one at small N
    tried = {"gather_chunk_bytes": {}, "scatter_path_pair": {}}
    small = ids[:40]
    outs = torch.empty((2, n, d), dtype=torch.bfloat16, device="cuda")
    for chunk in (512, 1024, 2048, 4096, 8192):
        def pair40(chunk=chunk):
            G.GATHER_PAIR(pool.data_ptr(), pool2.data_ptr(), outs.data_ptr(),
                          outs[1].data_ptr(), small.data_ptr(), 40, row,
                          chunk, G.map_arg(v, 40, *args))

        def single(chunk=chunk):
            G.GATHER(pool.data_ptr(), outs.data_ptr(), ids.data_ptr(), n,
                     row, chunk, G.map_arg(v, n, *args))
        tried["gather_chunk_bytes"][chunk] = {
            "pair_40_lines_ms": graph_ms(pair40, 100),
            f"single_{n}_lines_ms": graph_ms(single, 20)}
    claims = S.claim_words(pool.device, v).data_ptr()
    for m in (4, 32, 256):
        midx = _quarter_duplicated(ids[:m], gen)
        rmap = G.map_arg(v, m, *args)
        ptrs = (pool.data_ptr(), pool2.data_ptr(), upd.data_ptr(),
                upd2.data_ptr())

        def staged(midx=midx, rmap=rmap, m=m):
            S.SCATTER_PAIR(*ptrs, midx.data_ptr(), m, row,
                           G.chunk_bytes(m, row), rmap)

        def claimed(midx=midx, rmap=rmap, m=m):
            S.CLAIM(midx.data_ptr(), m, claims, rmap)
            S.CLAIMED_COPY(2, ptrs[0], ptrs[1], ptrs[2], ptrs[3],
                           midx.data_ptr(), m, row, claims, rmap)
        tried["scatter_path_pair"][m] = {"one_launch_ms": graph_ms(staged,
                                                                   100),
                                         "claimed_ms": graph_ms(claimed,
                                                                100)}
    for what, rows in tried.items():
        log(f"[row_times] tried, {what} (device time in a CUDA graph, us): "
            + "; ".join(f"{k}: " + ", ".join(f"{kk} {vv * 1e3:.3f}"
                                              for kk, vv in r.items())
                        for k, r in rows.items()))
    out["tried"] = tried
    out["max_abs_err"] = err
    return out


def phase_tables() -> dict:
    """The paper tables' path through its CLI entry point, held to the CPU
    pricing, the pins, the reproduction tolerances and the path's launch
    counts."""
    import torch

    from repro_torch.bench import paper_tables as PT
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE

    entries = {"banked_transpose": TRANSPOSE, **_fft_entries()}
    for e in entries.values():
        e.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = PT.main(["table2", "table3"])          # prints the rows
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: e.launches for name, e in entries.items()}
    # one 4096-point transform per Table III workload: one tile launch
    want = {"banked_transpose": len(PT.SIZES),
            "fft_transform_launch": len(PT.RADICES),
            "fft_wide_pass_launch": 0, "fft_stage_launch": 0}
    log(f"[tables] Tables II and III through the CLI on the card in "
        f"{secs:.2f} s; launches on the path: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")

    host = {"table2": PT.table2_rows("cpu"), "table3": PT.table3_rows("cpu")}
    for table in ("table2", "table3"):
        for c, h in zip(card[table], host[table], strict=True):
            c0 = {k: v for k, v in c.items() if k != "kernel_err"}
            h0 = {k: v for k, v in h.items() if k != "kernel_err"}
            if c0 != h0:
                raise AssertionError(f"card row {c0} != CPU row {h0}")
    log(f"[tables] card pricing == CPU pricing on all "
        f"{len(card['table2']) + len(card['table3'])} cells (and the VM's "
        f"func_err equal)")

    t2 = [r for r in card["table2"] if r["delta_pct"] != ""]
    t3 = [r for r in card["table3"] if r["delta_pct"] != ""]
    totals = {r["name"]: r["total"] for r in card["table2"] + card["table3"]}
    pins = {"transpose32_16B": 1613, "transpose64_16B": 5791,
            "transpose128_16B": 26087, "fft4096r4_16B": 64216}
    got_pins = {k: totals[k] for k in pins}
    r16 = next(r for r in t3 if r["name"] == "fft4096r16_4R-2W")
    checks = {
        "pins": got_pins == pins,
        "table2 |d| <= 1.1 %": max(abs(r["delta_pct"]) for r in t2) <= 1.1,
        "table2 >= 6 exact": sum(r["delta_pct"] == 0.0 for r in t2) >= 6,
        "table3 |d| <= 5 % (non-VB)": max(
            abs(r["delta_pct"]) for r in t3 if "VB" not in r["name"]) <= 5,
        "table3 |d| <= 8.5 % (VB)": max(
            abs(r["delta_pct"]) for r in t3 if "VB" in r["name"]) <= 8.5,
        "4R-2W r16 eff 33.3 +- 0.2": abs(r16["efficiency_pct"] - 33.3)
        <= 0.2,
        # the VM's float32 FFT and the kernel transform against the numpy
        # oracle: 2e-3·max|X| (tests/test_programs.py, test_kernels.py)
        "func_err <= 2e-3": all(r["func_rel_err"] <= 2e-3 for r in t3),
        "fft kernel_err <= 2e-3": all(r["kernel_err"] <= 2e-3 for r in t3),
        # the transpose moves bytes: exact
        "transpose kernel_err == 0": all(r["kernel_err"] == 0.0 for r in t2),
    }
    log(f"[tables] 16B pins {got_pins}; checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"table checks failed: {checks}")
    return {"launches": launches, "seconds": secs, "pins": got_pins,
            "table2": card["table2"], "table3": card["table3"],
            "kernel_err": {
                "banked_transpose": max(r["kernel_err"]
                                        for r in card["table2"]),
                "fft_stage": max(r["kernel_err"] for r in card["table3"])},
            "func_err": max(r["func_rel_err"] for r in card["table3"])}


def _claimed_scatter_captures() -> float:
    """The claimed scatter's workspace and CUDA graphs: two graphs (a
    single scatter of 3000 indices into 4096 rows, 8B-xor, and a paired
    one of 700 into 512, 16B-offset) captured on the one workspace an eager
    call made, replayed second first, then first, then second, each
    bit-equal to the plain version, the workspace zero after each; then,
    with no workspace on the card, a first claimed scatter inside a
    capture is refused (RuntimeError) before it allocates anything, as is
    one that would grow the workspace.  Returns the largest error."""
    import torch

    from repro_torch.kernels.banked_scatter import ops as S

    card = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=card).manual_seed(9)
    big = torch.zeros((4096, 64), device=card)
    small = [torch.zeros((512, 32), device=card) for _ in range(2)]
    i_big = torch.randint(0, 4096, (3000,), device=card, generator=gen)
    i_small = torch.randint(0, 512, (700,), device=card, generator=gen)
    u_big = torch.randn((3000, 64), device=card, generator=gen)
    u_small = [torch.randn((700, 32), device=card, generator=gen)
               for _ in range(2)]
    S.banked_scatter(big, i_big, u_big, 8, "xor")    # the workspace, eager
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with torch.cuda.graph(graphs[0]):
        S.banked_scatter(big, i_big, u_big, 8, "xor")
    with torch.cuda.graph(graphs[1]):
        S.banked_scatter_pair(*small, i_small, *u_small, 16, "offset")
    want = {0: [S.banked_scatter_plain(torch.zeros_like(big), i_big, u_big,
                                       8, "xor")],
            1: [S.banked_scatter_plain(torch.zeros_like(t), i_small, u, 16,
                                       "offset")
                for t, u in zip(small, u_small)]}
    err = 0.0
    for g in (1, 0, 1):
        for t in (big, *small):
            t.zero_()
        graphs[g].replay()
        torch.cuda.synchronize()
        for got, w in zip(([big], small)[g], want[g]):
            err = max(err, float((got - w).abs().max()))
            if not torch.equal(got, w):
                raise AssertionError(f"claimed scatter graph {g} replayed "
                                     f"!= plain")
        if S.claim_words(card, 4096).any():
            raise AssertionError("the claim workspace is not zero after a "
                                 "replay")
    made = S._CLAIMS
    S._CLAIMS = {}
    try:
        refused = 0
        table = torch.zeros((1024, 16), device=card)
        idx = torch.randint(0, 1024, (300,), device=card, generator=gen)
        upd = torch.ones((300, 16), device=card)
        for target in (table, None):
            if target is None:              # the workspace made, too small
                S.banked_scatter(table, idx, upd)
                target = torch.zeros((2048, 16), device=card)
            try:
                with torch.cuda.graph(torch.cuda.CUDAGraph()):
                    S.banked_scatter(target, idx, upd)
            except RuntimeError as e:
                if "eagerly" not in str(e):
                    raise
                refused += 1
        sizes = [w.numel() for w in S._CLAIMS.values()]
    finally:
        S._CLAIMS = made
    if refused != 2 or sizes != [1024]:
        raise AssertionError(f"captures refused {refused} of 2, workspace "
                             f"sizes {sizes} (want [1024])")
    log("[figures] claimed scatter: two graphs on one workspace replayed "
        "second first, bit-equal; a first claimed scatter and a growing "
        "one inside a capture refused")
    return err


#: the six paper per-workload winners (tests/test_tune.py:45-47) and the
#: two serving expectations, by autotune case
AUTOTUNE_WINNERS = {"transpose32": "4R-2W", "transpose64": "4R-2W",
                    "transpose128": "4R-2W", "fft4096r4": "16B-offset",
                    "fft4096r8": "16B-offset", "fft4096r16": "4R-1W-VB",
                    "serve_b4_p16_d8": "4R-2W", "serve_b8_p64_d64": "4R-1W"}


def phase_figures(smi: str) -> dict:
    """Table I, Fig 9, the autotuner (all its cases), its quickstart and
    the bank-scaling and beyond-paper sweeps, each through its CLI entry
    point on the card (each timing ended by a device sync), held to the
    same code on the host and to the reference's pins; the path reaches no
    kernel.  Runs the claimed scatter's capture checks first."""
    import torch

    from repro_torch.bench import autotune as AT
    from repro_torch.bench import bank_scaling as BS
    from repro_torch.bench import beyond_paper as BP
    from repro_torch.bench import paper_tables as PT
    from repro_torch.examples import autotune_quickstart as QS

    err = _claimed_scatter_captures()
    entries = {**_entries(), **_fft_entries()}
    for e in entries.values():
        e.launches = 0
    sections = {
        "table1": lambda: PT.main(["table1"])["table1"],
        "fig9": lambda: PT.main(["fig9"])["fig9"],
        "autotune": lambda: AT.main([]),
        "quickstart": lambda: QS.main([]),
        "bank_scaling": lambda: BS.main([]),
        "beyond_paper": lambda: BP.main([]),
    }
    card, secs = {}, {}
    for name, run in sections.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card[name] = run()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    launches = {name: e.launches for name, e in entries.items()}
    log(f"[figures] wall seconds on the card ({smi}): {secs}; kernel "
        f"launches on the path: {launches}")
    if any(launches.values()):
        raise AssertionError(f"the figures path launched {launches}")

    host = {"table1": PT.table1_rows(), "fig9": PT.fig9_rows("cpu"),
            "autotune": AT.rows(device="cpu"),
            "quickstart": QS.main(["--device", "cpu"]),
            "bank_scaling": BS.rows("cpu"), "beyond_paper": BP.rows("cpu")}
    for name in sections:
        if card[name] != host[name]:
            raise AssertionError(f"{name}: card rows != CPU rows")
    t1 = {r["name"]: r for r in card["table1"]}
    over = {r["name"] for r in card["fig9"]
            if r["footprint_alms"] == "over-capacity"}
    b16 = {r["footprint_alms"] for r in card["fig9"]
           if r["name"].endswith("_16B")}
    rows = {r["name"]: r for r in card["autotune"]}
    strategies = ("exhaustive", "hillclimb")
    winners = {(case, s): rows[f"autotune_{case}_{s}"]["winner"]
               for case in AUTOTUNE_WINNERS for s in strategies}
    evals = {case: (rows[f"autotune_{case}_exhaustive"]["evals"],
                    rows[f"autotune_{case}_hillclimb"]["evals"])
             for case in AUTOTUNE_WINNERS}
    checks = {
        "table1 16B footprint_max 16640":
            t1["mem_16B"]["footprint_max"] == 16640,
        "table1 4R-1W max 112 KB":
            t1["mem_4R-1W"]["max_capacity_kb"] == 112.0,
        "fig9 over-capacity {168,224}KB x 4R-1W":
            over == {"fig9_168KB_4R-1W", "fig9_224KB_4R-1W"},
        "fig9 16B footprint constant": len(b16) == 1,
        "autotune 16 rows, all match": len(rows) == 16 and all(
            r["match"] for r in rows.values()),
        "autotune winners": winners == {
            (case, s): w for case, w in AUTOTUNE_WINNERS.items()
            for s in strategies},
        "hillclimb never more evals, fewer in all": all(
            h <= e for e, h in evals.values()) and sum(
            h for _, h in evals.values()) < sum(
            e for e, _ in evals.values()),
        "quickstart extended hillclimb below 43 points":
            card["quickstart"]["fft4096r4_hillclimb"][1] < 43,
        "bank_scaling 10 rows": len(card["bank_scaling"]) == 10,
        "beyond_paper 20 rows": len(card["beyond_paper"]) == 20,
    }
    log(f"[figures] card rows == CPU rows in all six sections; autotune "
        f"evals (exhaustive, hillclimb) {evals}; checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"figure checks failed: {checks}")
    return {"seconds": secs, "nvidia_smi": smi, "launches": launches,
            "max_abs_err": {"banked_scatter": err}, "evals": evals,
            "table1": card["table1"], "fig9": card["fig9"],
            "autotune": card["autotune"], "quickstart": card["quickstart"],
            "bank_scaling": card["bank_scaling"],
            "beyond_paper": card["beyond_paper"]}


#: the reference's 16B cycles of every cost-bench row (``BENCH_cost.json``,
#: the full run): the pins the card's rows are held to
COST_PINS = {"transpose32": 1613, "serve_b4_p16_d8": 2596,
             "transpose64": 5791, "transpose128": 26087,
             "fft4096r4": 64216, "serve_b8_p64_d64": 22168,
             "stream_synthetic_serving": 17245144,
             "pipelined_thunk_stream": 5580, "warm_cache_window": 71327,
             "construct_transpose256": 135943,
             "construct_transpose1024": 2169223,
             "construct_transpose4096": 34701703}


def phase_cost_bench(smi: str) -> dict:
    """The cost-engine benchmark on the card: its CLI with ``--smoke
    --check`` (the reference's gates on the small points), then the full
    priced cases and the full million-op stream, held to the gates and to
    the reference's 16B pins, and the 4096² construction priced once, for
    its pin and its host peak (its rate is the full CLI's ``--check``);
    the full registry (two-level points included) priced on the card
    equals the CPU pricing; the path launches none of the seven kernels."""
    import torch

    from repro_torch.bench import cost_bench as CB
    from repro_torch.core import arch as A
    from repro_torch.core.cost_engine import cost_many
    from repro_torch.core.trace import AddressTrace

    def construct_once(n):
        costs = []
        peak = CB._peak_bytes(lambda: costs.append(cost_many(
            [A.resolve("16B")], CB.construction_stream(n),
            block_ops=CB.STREAM_BLOCK_OPS, device="cuda")[0]))
        n_ops = 2 * n * n // 16
        return {"workload": f"construct_transpose{n}", "n_ops": n_ops,
                "block_ops": CB.STREAM_BLOCK_OPS,
                "dense_matrix_bytes": n_ops * 16 * 4,
                "stream_peak_bytes": int(peak), "peak_gated": True,
                "peak_floor_bytes": CB.PEAK_FLOOR_BYTES,
                "total_cycles_16B": costs[0].total_cycles}

    entries = {**_entries(), **_fft_entries()}
    for e in entries.values():
        e.launches = 0
    archs = [A.get(n) for n in CB.ARCH_NAMES]
    out_dir = ROOT / "chiprun_out"
    secs, rows = {}, {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return got

    for r in timed("smoke_cli", lambda: CB.main(
            ["--smoke", "--check", "--out",
             str(out_dir / "cost_bench_smoke.json")])):
        rows[f"smoke:{r['workload']}"] = r
    cases = [(n, t) for n, t in CB._cases(False) if f"smoke:{n}" not in rows]
    for name, trace in cases:
        rows[name] = timed(name, lambda: CB.bench_case(name, trace, archs))
    rows["stream_synthetic_serving"] = timed(
        "stream_synthetic_serving",
        lambda: CB.bench_million_op_stream(archs, smoke=False))
    rows["construct_transpose4096"] = timed(
        "construct_transpose4096", lambda: construct_once(4096))
    launches = {name: e.launches for name, e in entries.items()}

    # the full registry on the card against the CPU, on every case's trace
    # and on a random masked trace with far addresses
    registry = sorted(A.names())
    rng = np.random.default_rng(26)
    n = 3000
    masked = AddressTrace(rng.integers(0, 1 << 24, (n, 16)),
                          rng.integers(0, 3, n),
                          np.sort(rng.integers(0, n // 3, n)),
                          rng.random((n, 16)) > 0.3)
    traces = dict(CB._cases(False))
    traces["random_masked"] = masked

    def registry_pricing(device):
        return {name: cost_many(registry, t, device=device)
                for name, t in traces.items()}

    card = timed("registry_card", lambda: registry_pricing("cuda"))
    host = registry_pricing("cpu")
    launches_after = {name: e.launches for name, e in entries.items()}

    full = [r for k, r in rows.items() if not k.startswith("smoke:")]
    failures = CB.check(full)
    got16 = {r["workload"]: r["total_cycles_16B"] for r in rows.values()}
    checks = {
        "full rows pass the reference's gates": not failures,
        "every 16B pin": got16 == COST_PINS,
        "registry of 14 on the card == CPU": len(registry) == 14
        and card == host,
        "two-level points priced": all(
            n in registry for n in ("4x4B-g64", "2x8B-g32", "4x3B")),
        "no kernel launched": not any(launches_after.values()),
    }
    log(f"[cost_bench] wall seconds on the card ({smi}): {secs}; kernel "
        f"launches on the path: {launches}")
    for r in rows.values():
        log(f"[cost_bench] {r}")
    log(f"[cost_bench] 16B cycles {got16}; failures {failures}; "
        f"checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"cost bench checks failed: {checks}, "
                             f"{failures}")
    return {"seconds": secs, "nvidia_smi": smi, "launches": launches_after,
            "rows": rows, "registry": registry}


def phase_serving_bench(smi: str) -> dict:
    """The serving benchmark (``repro_torch.bench.serving_bench``) through
    its ``main`` on the card: the full grid with ``--check`` (its live
    check's paired row launches counted, no plain call), ``--chaos --smoke
    --check`` and ``--smoke``; every row, the ranking report and the chaos
    row equal the same functions with ``--device cpu``, and every pin and
    gate holds.  Then both serving examples through their ``main`` on the
    card."""
    import contextlib
    import io

    import torch

    from repro_torch.bench import serving_bench as SB
    from repro_torch.examples import paged_kv_serving, serve_lm
    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    secs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as text:
            got = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return got, text.getvalue().splitlines()

    (full, full_lines), _, launches, entries = _counted_path(
        "serving_bench", lambda: timed("check", lambda: SB.main(
            ["--check", "--out", str(out_dir / "serving_bench.json")])),
        lambda r: r[0]["scheduler"]["checks"][0]["row_launches"])
    chaos, chaos_lines = timed("chaos", lambda: SB.main(
        ["--chaos", "--smoke", "--check", "--out",
         str(out_dir / "serving_bench_chaos.json")]))
    smoke, _ = timed("smoke", lambda: SB.main(
        ["--smoke", "--out", str(out_dir / "serving_bench_smoke.json")]))
    # the same functions priced on the host
    t0 = time.perf_counter()
    host_rows = SB.rows(device="cpu")
    host_sched = SB.sched_rows(device="cpu")
    host_flips = SB.ranking_flip_report(host_sched, device="cpu")
    host_chaos, _ = SB.chaos_section(device="cpu")
    secs["host_pricing"] = time.perf_counter() - t0
    live, day = full["scheduler"]["checks"]
    checks = {
        "serving rows == CPU": full["serving"] == host_rows,
        "scheduled rows == CPU": full["scheduler"]["rows"] == host_sched,
        "ranking == CPU": full["scheduler"]["ranking"] == host_flips,
        "chaos row == CPU": chaos["faults"] == host_chaos,
        "smoke rows are the grid's first": (
            smoke["serving"] == host_rows[:9]
            and smoke["scheduler"]["rows"] == host_sched[:18]),
        "live == sim, 80 ops, 2800 / 128 cycles": live["ok"] and (
            live["n_ops"], live["cycles"]) == (80, {"16B": 2800,
                                                     "4R-2W": 128}),
        "streamed day under half the dense matrix": day["ok"],
        "low-arrival days flip to 4R-1W": full["scheduler"]["ranking"][
            "has_flip"] and full["scheduler"]["ranking"][
            "fixed_batch_winner"] == "4R-2W" and all(
            v["arch"] == "4R-1W" for k, v in full["scheduler"]["ranking"][
                "day_winners"].items() if "_r0.5_" in k),
        "chaos pins 2800 / 4660 / 4668": chaos["faults"]["cycles"] == {
            "healthy": 2800, "faulted": 4660, "faulted_degraded": 4668}
        and chaos["faults"]["ok"],
        "check OK printed": full_lines[-1].startswith("# check OK")
        and chaos_lines[-1].startswith("# chaos check OK"),
    }
    log(f"[serving_bench] wall seconds on the card ({smi}): {secs}; the "
        f"live check's row launches {launches} by entry {entries}")
    log(f"[serving_bench] streamed day: {day}")
    log(f"[serving_bench] ranking: {full['scheduler']['ranking']}")
    log(f"[serving_bench] chaos: {chaos['faults']}")
    log(f"[serving_bench] checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"serving bench checks failed: {checks}")

    # the two examples on the card; the first's prices and tuner picks
    # equal to its run on the host
    ex, ex_lines = {}, {}
    for name, main in (("paged_kv_serving", paged_kv_serving.main),
                       ("serve_lm", serve_lm.main)):
        ex[name], ex_lines[name] = timed(name, lambda: main([]))
        log(f"[serving_bench] examples/{name}: {secs[name]:.2f} s; last "
            f"line {ex_lines[name][-1]!r}")
    host_ex, _ = timed("paged_kv_serving_cpu",
                       lambda: paged_kv_serving.main(["--device", "cpu"]))
    card_ex = ex["paged_kv_serving"]
    log(f"[serving_bench] paged_kv_serving cycles {card_ex['cycles']}, "
        f"picks {card_ex['picks']}; on the host {host_ex['cycles']}, "
        f"{host_ex['picks']}")
    if not (ex_lines["paged_kv_serving"][-1]
            == "banked paged-KV serving verified end-to-end ✓"
            and ex_lines["serve_lm"][-1] == "greedy decode deterministic ✓"
            and (card_ex["cycles"], card_ex["picks"], card_ex["n_ops"])
            == (host_ex["cycles"], host_ex["picks"], host_ex["n_ops"])):
        raise AssertionError(f"the examples printed {ex_lines}")
    wall = time.perf_counter() - t_phase
    log(f"[serving_bench] phase wall time {wall:.2f} s ({smi})")
    return {"seconds": secs, "launches": launches, "entries": entries,
            "streamed_day": day, "live_check": live,
            "ranking": full["scheduler"]["ranking"],
            "chaos": chaos["faults"], "checks": checks,
            "examples": ex_lines, "wall_s": wall, "nvidia_smi": smi}


#: the reference's whole-step winners (``benchmarks/model_traffic_bench.py``
#: pins llama's; mixtral's and jamba's are what it computes, held equal in
#: ``tests/test_torch_model_traces.py``)
MODEL_WINNERS = {"llama3.2-1b": "16B", "mixtral-8x22b": "16B",
                 "jamba-v0.1-52b": "16B-offset"}


def phase_model_traffic(smi: str) -> dict:
    """The model-traffic bench (``repro_torch.bench.model_traffic_bench``)
    through its ``main`` on the card with ``--check``, each section's wall
    time taken (the rows, the ranking, the gates); every row and the
    ranking equal to the same functions priced with ``device="cpu"``, the
    pins (16B / 4R-1W / the flip) and the streamed mixtral step's gate
    held; the path launches no kernel (``moe_a2a`` takes the dispatch's
    ``ref``, as the reference does)."""
    import contextlib
    import io

    import torch

    from repro_torch.bench import model_traffic_bench as MT
    t_phase = time.perf_counter()
    entries = _entries()
    for e in entries.values():
        e.launches = 0
    secs = {}
    originals = {name: getattr(MT, name)
                 for name in ("rows", "ranking_report", "check")}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(*args, **kw)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            return got
        return call
    for name, fn in originals.items():
        setattr(MT, name, timed(name, fn))
    try:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            card = timed("main", MT.main)(
                ["--check", "--out",
                 str(ROOT / "chiprun_out" / "model_traffic_bench.json")])
    finally:
        for name, fn in originals.items():
            setattr(MT, name, fn)
    lines = text.getvalue().splitlines()
    launches = {name: e.launches for name, e in entries.items()}
    # the same functions priced on the host
    t0 = time.perf_counter()
    host_rows = MT.rows(device="cpu")
    host_rank = MT.ranking_report(device="cpu")
    host_step = MT.check_streamed_step(device="cpu")
    secs["host_pricing"] = time.perf_counter() - t0
    step = card["checks"][0]
    winners = {m: w["arch"]
               for m, w in card["ranking"]["model_winners"].items()}
    checks = {
        "rows == CPU": card["rows"] == host_rows,
        "27 rows": len(card["rows"]) == 27,
        "ranking == CPU": card["ranking"] == host_rank,
        "pins 16B / 4R-1W / flip": (
            winners["llama3.2-1b"] == MT.PIN_MODEL_WINNER
            and card["ranking"]["kernel_winners"]["attn_decode"]
            == MT.PIN_ATTN_KERNEL_WINNER
            and card["ranking"]["llama_flips_attn_kernel"] == MT.PIN_FLIPS),
        "whole-step winners": winners == MODEL_WINNERS,
        "streamed step == CPU": all(
            step[k] == host_step[k] for k in ("n_ops", "total_cycles_16B",
                                              "dense_matrix_bytes")),
        "streamed step under half the dense matrix": step["ok"] and (
            step["dense_matrix_bytes"] >= MT.PEAK_HEADROOM * (
                step["stream_peak_bytes"] + step["pinned_bytes"])),
        "check OK printed": lines[-1].startswith("# check OK"),
        "no kernel launched": not any(launches.values()),
    }
    wall = time.perf_counter() - t_phase
    log(f"[model_traffic] wall seconds on the card ({smi}): {secs}; "
        f"kernel launches on the path: {launches}")
    log(f"[model_traffic] whole-step winners {winners}; kernel winners "
        f"{card['ranking']['kernel_winners']}")
    log(f"[model_traffic] streamed mixtral step: {step['n_ops']} ops, host "
        f"peak {step['stream_peak_bytes']} B + {step['pinned_bytes']} B "
        f"staged against the dense {step['dense_matrix_bytes']} B, priced "
        f"on 9 memories in {step['price_s']} s (host pricing "
        f"{host_step['price_s']} s); checks: {checks}")
    log(f"[model_traffic] phase wall time {wall:.2f} s ({smi})")
    if not all(checks.values()):
        raise AssertionError(f"model traffic checks failed: {checks}")
    return {"seconds": secs, "launches": launches, "winners": winners,
            "ranking": card["ranking"], "streamed_step": step,
            "host_streamed_step": host_step, "checks": checks,
            "rows": card["rows"], "wall_s": wall, "nvidia_smi": smi}


def phase_quickstart(smi: str) -> dict:
    """The port's quickstart (``repro_torch.examples.quickstart``) through
    its ``main`` on the card: its printed lines and values equal its run
    on the host; section 3's gather ran as the hand-written
    ``gather_rows`` (one launch of the single-table entry by the launch
    counters, one ``gather_rows`` kernel by ``torch.profiler``) and is
    bit-equal to its plain version on the same CUDA inputs."""
    import contextlib
    import io

    import torch

    from repro_torch.core import arch as A
    from repro_torch.examples import quickstart as QS
    from repro_torch.kernels.banked_gather.ops import (GATHERS,
                                                       banked_gather_plain)
    entries = _entries()
    for e in entries.values():
        e.launches = 0

    def run(argv):
        with contextlib.redirect_stdout(io.StringIO()) as text:
            got = QS.main(argv)
        return got, text.getvalue()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card, card_text = run([])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: e.launches for name, e in entries.items()}
    by_entry = GATHERS.by_entry()
    host, host_text = run(["--device", "cpu"])
    table, idx, rows = card["gather"]
    lay = A.get("16B-offset").layout
    want = banked_gather_plain(lay.to_banked(table), idx, lay.n_banks,
                               lay.mapping, shift=lay.shift)
    err = _row_cases_equal("banked_gather", "the quickstart's section 3",
                           [(rows, want)])
    # which CUDA kernels a quickstart run launches, by torch.profiler
    names = [e.name for e in _profiled_kernels(lambda: run([]))]
    gather_kernels = [n for n in names if "gather_rows" in n]
    checks = {
        "printed == CPU": card_text == host_text,
        "values == CPU": {k: v for k, v in card.items() if k != "gather"}
        == {k: v for k, v in host.items() if k != "gather"},
        "rows == CPU": torch.equal(rows.cpu(), host["gather"][2]),
        "one gather launch, single-table entry": launches == {
            **{k: 0 for k in launches}, "banked_gather": 1}
        and by_entry["banked_gather_launch"] == 1,
        "one gather_rows kernel by the profiler": len(gather_kernels) == 1,
    }
    log(f"[quickstart] {secs:.2f} s on the card ({smi}); launches {launches}"
        f" by entry {by_entry}; profiled CUDA kernels {len(names)}, "
        f"gather_rows {gather_kernels}; section 3 rows == plain (err {err})"
        f"; checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"quickstart checks failed: {checks}")
    return {"seconds": secs, "launches": launches, "entries": by_entry,
            "profiled_gather_kernels": gather_kernels,
            "max_abs_err": {"banked_gather": err}, "checks": checks,
            "printed": card_text.splitlines(), "nvidia_smi": smi}


def _check_fft_pass(xr, xi, n, p, err, what) -> tuple:
    """The kernel pass and the plain pass on the same CUDA planes, rtol =
    atol = 1e-5 (tests/test_kernels.py:140-143); returns the plain output,
    the input of the next pass."""
    import torch

    from repro_torch.kernels.fft_stage.ops import (fft_stage_radix4,
                                                   stage_twiddles)
    from repro_torch.kernels.fft_stage.ref import fft_stage_ref
    got = fft_stage_radix4(xr, xi, n, p)
    sub = n // 4 ** (p + 1)
    twr, twi = stage_twiddles(n, p, xr.device)
    want = fft_stage_ref(xr.reshape(-1, 4, sub), xi.reshape(-1, 4, sub),
                         twr, twi)
    want = tuple(w.reshape(xr.shape) for w in want)
    torch.cuda.synchronize()
    e = max((g - w).abs().max().item() for g, w in zip(got, want))
    close = all(torch.allclose(g, w, rtol=1e-5, atol=1e-5)
                for g, w in zip(got, want))
    err["fft_stage"] = max(err["fft_stage"], e)
    log(f"[{what}] fft_stage pass {p} of n={n} on {tuple(xr.shape)}: max "
        f"|kernel - plain| {e:.3g} (rtol = atol = 1e-5: {close})")
    if not close:
        raise AssertionError(f"fft_stage pass {p} of n={n} != plain")
    return want


def _fft_entries() -> dict:
    """The FFT's C entries by symbol: the transform's two and the planar
    pass of the one-pass API."""
    from repro_torch.kernels.fft_stage.ops import STAGE, TRANSFORM, WIDE_PASS
    return {"fft_transform_launch": TRANSFORM,
            "fft_wide_pass_launch": WIDE_PASS, "fft_stage_launch": STAGE}


def _check_fft_full(x, err, what) -> None:
    """The kernel transform against the plain passes (torch.equal) and the
    numpy oracle (atol 2e-3·max|X|, tests/test_kernels.py:153-154), in
    transform_plan(n) + 1 launches and no planar pass."""
    import torch

    from repro_torch.isa.programs.fft import digit_reverse_indices
    from repro_torch.kernels.fft_stage import fft4096_radix4, fft_radix4_ref
    from repro_torch.kernels.fft_stage.ops import transform_plan
    n = x.shape[-1]
    entries = _fft_entries()
    before = {k: e.launches for k, e in entries.items()}
    got = fft4096_radix4(x, n=n)
    ran = {k: e.launches - before[k] for k, e in entries.items()}
    plain = fft_radix4_ref(x, n=n)
    torch.cuda.synchronize()
    # fft_oracle_digit_reversed, all rows at once
    spectrum = np.fft.fft(x.cpu().numpy(), axis=-1)
    oracle = np.empty_like(spectrum)
    oracle[:, digit_reverse_indices(n, 4)] = spectrum
    tol = 2e-3 * np.abs(oracle).max()
    equal = torch.equal(got, plain)
    e_plain = (got - plain).abs().max().item()
    e_oracle = float(np.abs(got.cpu().numpy() - oracle).max())
    err["fft_stage"] = max(err["fft_stage"], e_plain)
    want = {"fft_transform_launch": 1,
            "fft_wide_pass_launch": transform_plan(n),
            "fft_stage_launch": 0}
    log(f"[{what}] fft4096_radix4 n={n} on {tuple(x.shape)}: equal to plain: "
        f"{equal}, max |kernel - oracle| {e_oracle:.3g} (tolerance "
        f"{tol:.3g}), launches {ran}")
    if not equal or e_oracle > tol or ran != want:
        raise AssertionError(f"fft transform n={n}: equal {equal} (max "
                             f"|diff| {e_plain:.3g}), oracle {e_oracle:.3g} "
                             f"> {tol:.3g} or launches {ran} != {want}")


def _check_transpose(x, err, what) -> None:
    import torch

    from repro_torch.kernels.banked_transpose.ops import banked_transpose
    from repro_torch.kernels.banked_transpose.ref import banked_transpose_ref
    got, want = banked_transpose(x), banked_transpose_ref(x)
    torch.cuda.synchronize()
    e = (got.float() - want.float()).abs().max().item()
    err["banked_transpose"] = max(err["banked_transpose"], e)
    same = torch.equal(got, want) and got.is_contiguous()
    log(f"[{what}] banked_transpose {tuple(x.shape)} {x.dtype}: bit-equal "
        f"to plain: {same}")
    if not same:
        raise AssertionError(f"banked_transpose != plain at "
                             f"{tuple(x.shape)} {x.dtype} (err {e})")


def phase_table_kernels() -> dict:
    """Both kernels against their plain versions at the shapes the tables'
    path gives them: the N×N f32 inputs of the Table II memory images and
    every pass of the Table III 4096-point input."""
    import torch

    from repro_torch.bench import paper_tables as PT
    from repro_torch.bench.workloads import fft_workload, transpose_workload
    err = {"banked_transpose": 0.0, "fft_stage": 0.0}
    for n in PT.SIZES:
        mem = transpose_workload(n).init_memory
        _check_transpose(torch.from_numpy(mem[:n * n].reshape(n, n)).cuda(),
                         err, "path")
    mem, n = fft_workload(PT.FFT_N, 4).init_memory, PT.FFT_N
    x = torch.from_numpy((mem[0:2 * n:2] + 1j * mem[1:2 * n:2]).astype(
        np.complex64)[None]).cuda()
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    for p in range(6):
        xr, xi = _check_fft_pass(xr, xi, n, p, err, "path")
    _check_fft_full(x, err, "path")
    return {"max_abs_err": err}


def phase_table_sweep() -> dict:
    """The reference tests' layouts (tests/test_kernels.py:130-166)."""
    import torch
    err = {"banked_transpose": 0.0, "fft_stage": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for shape in ((128, 128), (256, 512), (512, 128), (32, 32)):
        for dtype in (torch.float32, torch.bfloat16, torch.int32):
            x = torch.randint(-1000, 1000, shape, device="cuda",
                              generator=gen).to(dtype)
            _check_transpose(x, err, "sweep")
    for n, p in ((4096, 0), (4096, 3), (4096, 5), (1024, 2)):
        xr = torch.randn((2, n), device="cuda", generator=gen)
        xi = torch.randn((2, n), device="cuda", generator=gen)
        _check_fft_pass(xr, xi, n, p, err, "sweep")
    rng = np.random.default_rng(0)
    for n in (256, 1024, 4096):
        x = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
             ).astype(np.complex64)
        _check_fft_full(torch.from_numpy(x).cuda(), err, "sweep")
    # below a tile (ragged last tiles at batch 1 and 3) and above it (one
    # and two wide passes before the tile launch)
    for n in (4, 16, 64, 16384, 65536):
        for batch in (1, 3, 1024):
            x = torch.complex(
                torch.randn((batch, n), device="cuda", generator=gen),
                torch.randn((batch, n), device="cuda", generator=gen))
            _check_fft_full(x, err, "sweep")
    return {"max_abs_err": err}


TRANSPOSE_TIMING = (8192, 8192)     # f32: 512 MiB moved
FFT_TIMING = (1024, 4096)           # complex64 transforms: 64 MiB moved
FFT_WIDE_TIMING = (64, 65536)       # the same bytes in a three-launch plan


def _fft_launch_ms(call) -> dict:
    """Device time of each of the transform's kernels (torch.profiler over
    5 calls), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    return {name: ev.self_device_time_total / ev.count / 1e3
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            for name in ("wide_pass", "transform_tile")
            if name in ev.key and ev.count}


def phase_table_times() -> dict:
    import torch

    from repro_torch.bench.kernel_bench import bound_ms, timed
    from repro_torch.kernels.banked_transpose.ops import banked_transpose
    from repro_torch.kernels.banked_transpose.ref import banked_transpose_ref
    from repro_torch.kernels.fft_stage import (fft4096_radix4,
                                               fft_radix4_ref)
    from repro_torch.kernels.fft_stage.ops import (
        fft_stage, stage_twiddles, transform_plan, transform_twiddles)
    from repro_torch.kernels.fft_stage.ref import fft_stage_ref
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}

    n, m = TRANSPOSE_TIMING
    x = torch.randn((n, m), device="cuda", generator=gen)
    out["banked_transpose"] = timed(
        lambda: banked_transpose(x), lambda: banked_transpose_ref(x),
        lambda: x.t().contiguous(), bound_ms(2 * n * m * 4),
        graph_iters=20, iters=50)
    out["banked_transpose"]["shape"] = [n, m]

    fft = {}
    for batch, nf in (FFT_TIMING, FFT_WIDE_TIMING):
        z = torch.complex(
            torch.randn((batch, nf), device="cuda", generator=gen),
            torch.randn((batch, nf), device="cuda", generator=gen))
        passes = int(round(np.log(nf) / np.log(4)))
        # the function: each complex64 input read once, each output
        # written once; 40 flops per radix-4 butterfly column, nf/4
        # columns per pass
        flops = batch * passes * (nf // 4) * 40
        r = timed(lambda: fft4096_radix4(z, n=nf),
                  lambda: fft_radix4_ref(z, n=nf), lambda: torch.fft.fft(z),
                  bound_ms(2 * batch * nf * 8, flops), graph_iters=20,
                  iters=50)
        # what this design moves: each launch reads and writes the array
        # once, and the launches read the twiddle table once
        first = transform_plan(nf)
        r["design_bound_ms"] = bound_ms(
            (first + 1) * 2 * batch * nf * 8
            + transform_twiddles(nf, z.device).numel() * 8)[0]
        r["launches_per_call"] = first + 1
        r["launch_device_ms"] = _fft_launch_ms(lambda: fft4096_radix4(z,
                                                                      n=nf))
        r["shape"] = [batch, nf]
        fft[nf] = r
    out["fft_stage"] = fft[FFT_TIMING[1]]
    out["fft_stage"]["wide"] = fft[FFT_WIDE_TIMING[1]]
    # one planar pass alone (the one-pass API): two f32 planes in and out
    # plus the pass's twiddles
    batch, nf = FFT_TIMING
    xr = torch.randn((batch, nf), device="cuda", generator=gen)
    xi = torch.randn((batch, nf), device="cuda", generator=gen)
    per_pass = {}
    for p in (0, 5):
        sub = nf // 4 ** (p + 1)
        twr, twi = stage_twiddles(nf, p, xr.device)
        vr, vi = xr.reshape(-1, 4, sub), xi.reshape(-1, 4, sub)
        per_pass[p] = timed(
            lambda: fft_stage(vr, vi, twr, twi),
            lambda: fft_stage_ref(vr, vi, twr, twi), None,
            bound_ms(4 * batch * nf * 4 + 2 * 4 * sub * 4,
                      batch * (nf // 4) * 40), graph_iters=20, iters=50)
    out["fft_stage"]["passes"] = per_pass
    for name, r in (("banked_transpose", out["banked_transpose"]),
                    ("fft_stage", fft[FFT_TIMING[1]]),
                    ("fft_stage", fft[FFT_WIDE_TIMING[1]])):
        us = {k: (v * 1e3 if isinstance(v, float) else v)
              for k, v in r.items() if k.endswith("ms")}
        lib = "library" if name == "banked_transpose" else "torch.fft.fft"
        log(f"[times] {name} at {r['shape']}: per call from Python: kernel "
            f"{us['ms']:.2f} us, plain {us['plain_ms']:.2f} us, {lib} "
            f"{us['library_ms']:.2f} us; device time in a CUDA graph: kernel "
            f"{us['device_ms']:.3f} us, {lib} {us['library_device_ms']:.3f} "
            f"us; bound {us['bound_ms']:.3f} us ({r['bound_by']})")
    for r in fft.values():
        split = ", ".join(f"{k} {v * 1e3:.3f} us"
                          for k, v in r["launch_device_ms"].items())
        log(f"[times] fft_stage at {r['shape']}: {r['launches_per_call']} "
            f"launches a call, their bytes bound this design at "
            f"{r['design_bound_ms'] * 1e3:.3f} us; per launch "
            f"(torch.profiler, 5 calls): {split}")
    for p, r in per_pass.items():
        log(f"[times] fft_stage planar pass {p} alone at {list(FFT_TIMING)}:"
            f" per call kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us; device {r['device_ms'] * 1e3:.3f}"
            f" us; bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    return out


def _held(name, entry, what, kern, plain, err) -> None:
    """One call of the kernel against its plain version on the same CUDA
    inputs: bit-equal (integers: tolerance 0) and exactly one launch."""
    import torch
    before = entry.launches
    got = kern()
    ran = entry.launches - before
    want = plain()
    torch.cuda.synchronize()
    got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
    same = all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want, strict=True))
    e = max((g - w).abs().max().item() for g, w in zip(got, want))
    err[name] = max(err[name], float(e))
    log(f"[controllers] {name}, {what}: bit-equal to plain: {same}, "
        f"launches {ran}")
    if not same or ran != 1:
        raise AssertionError(f"{name} at {what}: equal {same}, max |diff| "
                             f"{e}, launches {ran}")


def _profiled_kernels(fn, tries: int = 6) -> list:
    """The CUDA kernels (profiler events, in start order) that ``fn`` runs,
    by torch.profiler after a warm-up call: the session brackets ``fn``
    between ``fill_`` marker kernels on a float64 scalar and keeps what
    lies between.  A session can drop its first kernel, so it opens with
    two markers and needs one of them; a session that lacks its markers
    is taken again, up to ``tries`` times, and what each such session
    recorded goes into the error."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    mark = torch.zeros(1, device="cuda", dtype=torch.float64)
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for value in (1, 2, None, 3):
                if value is None:
                    fn()
                else:
                    mark.fill_(value)
                torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        # the closing marker is the last kernel; one or two open the run
        lead = 0
        while (lead < 2 and lead < len(kernels) - 1
               and kernels[lead].name == kernels[-1].name):
            lead += 1
        if lead:
            return kernels[lead:-1]
        seen.append((len(kernels), [e.name[:40] for e in kernels[:1]
                                    + kernels[-1:]]))
        time.sleep(0.5)
    raise AssertionError(f"torch.profiler recorded no marker kernels in "
                         f"{tries} sessions (CUDA events, first and last "
                         f"kernel of each: {seen})")


def phase_controllers() -> dict:
    """Both controller kernels against their plain versions on the card:
    the reference tests' sweeps (tests/test_kernels.py:58-97) and the edge
    cases (ids outside [0, B), lane counts other than 16, unaligned rows,
    bank counts without a template, words that do not drain)."""
    import torch

    from repro_torch.core.arbiter import pack_requests
    from repro_torch.core.conflicts import bank_onehot
    from repro_torch.kernels.carry_arbiter.ops import (ARBITER,
                                                       carry_arbiter,
                                                       carry_arbiter_plain)
    from repro_torch.kernels.conflict_popcount.ops import (
        POPCOUNT, conflict_popcount, conflict_popcount_plain)
    rng = np.random.default_rng(5)
    err = {"conflict_popcount": 0.0, "carry_arbiter": 0.0}

    def cuda(a):
        return torch.as_tensor(a, device="cuda")

    flat = cuda(rng.integers(0, 16, 16 * 8 + 1).astype(np.int32))
    pop = [(f"sweep ({n}, 16) B={b}", cuda(rng.integers(0, b, (n, 16))), b)
           for n in (8, 256, 1024) for b in (4, 8, 16)]
    pop += [
        ("ids [0, 1, 17, -1, 2 x 12]",
         cuda(np.array([[0, 1, 17, -1] + [2] * 12] * 8)), 16),
        ("ids in [-4, 36), B=32", cuda(rng.integers(-4, 36, (256, 16))), 32),
        ("B=12 (no template)", cuda(rng.integers(0, 12, (512, 16))), 12),
        ("B=6 with ids in [-1, 8)", cuda(rng.integers(-1, 8, (256, 16))), 6),
        ("(8, 12) zeros", cuda(np.zeros((8, 12), np.int32)), 16),
        ("(8, 40): the first 16 lanes count",
         cuda(rng.integers(0, 16, (8, 40))), 16),
        ("rows 4 bytes off 16-byte alignment", flat[1:].view(8, 16), 16),
    ]
    for what, banks, b in pop:
        _held("conflict_popcount", POPCOUNT, what,
              lambda: conflict_popcount(banks, b),
              lambda: conflict_popcount_plain(banks, b), err)

    arb = []
    for n, b in ((8, 16), (128, 16), (256, 8)):
        banks = torch.as_tensor(rng.integers(0, b, (n, 16)))
        arb.append((f"sweep ({n}, {b})", cuda(pack_requests(
            bank_onehot(banks, b).transpose(-1, -2)))))
    drain = cuda(np.zeros((8, 16), np.int64))
    drain[:, 0] = 0xFFFF                      # all 16 lanes on bank 0
    arb += [("all 16 lanes on bank 0", drain),
            ("32-bit words (do not drain)",
             cuda(rng.integers(0, 2 ** 32, (128, 16)))),
            ("int32 words, 0xFFFFFFFF as -1",
             cuda(np.full((4, 12), -1, np.int32))),
            ("(384, 6)", cuda(rng.integers(0, 2 ** 16, (384, 6)))),
            ("int64 words with high bits set and negative words",
             cuda(np.array([[-1, -2 ** 31, 2 ** 32 + 5, 2 ** 63 - 1,
                             -2 ** 63, 2 ** 40 - 3, -(2 ** 33) + 0xF0F0,
                             0x1_0000_FFFF] * 2] * 128, np.int64))),
            ("int64 words in [-2^40, 2^40), (256, 12)",
             cuda(rng.integers(-2 ** 40, 2 ** 40, (256, 12)))),
            ("(128, 300): rows of 38,400 bytes in two 32 KB chunks",
             cuda(rng.integers(-2 ** 40, 2 ** 40, (128, 300)))),
            ("(2, 4100): chunks ending inside a cycle's banks",
             cuda(rng.integers(-2 ** 40, 2 ** 40, (2, 4100))))]
    for what, reqs in arb:
        _held("carry_arbiter", ARBITER, what, lambda: carry_arbiter(reqs),
              lambda: carry_arbiter_plain(reqs), err)
    kernels_per_call = {}
    for dtype in (torch.int64, torch.int32):
        reqs = cuda(rng.integers(-2 ** 40, 2 ** 40, (1024, 16))).to(dtype)
        names = [e.name for e in _profiled_kernels(
            lambda: carry_arbiter(reqs))]
        kernels_per_call[str(dtype)] = names
        log(f"[controllers] carry_arbiter on {dtype} words: CUDA kernels "
            f"of one call (torch.profiler): {names}")
        if len(names) != 1 or "arbiter" not in names[0]:
            raise AssertionError(f"an arbiter call on {dtype} ran {names}")
    bank0 = carry_arbiter(drain)[0, :, 0].cpu()
    ones = ((bank0 & (bank0 - 1)) == 0) & (bank0 != 0)
    drained = bool(ones.all()) and int(np.bitwise_or.reduce(
        bank0.numpy())) == 0xFFFF
    log(f"[controllers] bank 0 grants one distinct lane a cycle for 16 "
        f"cycles: {drained}")
    if not drained:
        raise AssertionError("the arbiter does not drain 16 requests")
    return {"max_abs_err": err, "cases": {"conflict_popcount": len(pop),
                                          "carry_arbiter": len(arb)},
            "arbiter_kernels_per_call": kernels_per_call}


def _entries() -> dict:
    """Every kernel's C entry (its launch count), by kernel name; the row
    kernels' and the dispatch's are the sums over their entries, the FFT's
    the transform's tile launch (the bench's row runs n = 4096)."""
    from repro_torch.kernels.banked_gather.ops import GATHERS
    from repro_torch.kernels.banked_scatter.ops import SCATTERS
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE
    from repro_torch.kernels.carry_arbiter.ops import ARBITER
    from repro_torch.kernels.conflict_popcount.ops import POPCOUNT
    from repro_torch.kernels.fft_stage.ops import TRANSFORM
    from repro_torch.kernels.moe_dispatch.ops import DISPATCH
    return {"banked_gather": GATHERS, "banked_scatter": SCATTERS,
            "banked_transpose": TRANSPOSE, "fft_stage": TRANSFORM,
            "conflict_popcount": POPCOUNT, "carry_arbiter": ARBITER,
            "moe_dispatch": DISPATCH}


#: the kernel bench's rows (``benchmarks/kernel_bench.py``'s six) and the
#: kernel each one runs
BENCH_ROWS = {"banked_gather_1024x512_r256": "banked_gather",
              "conflict_popcount_4096ops": "conflict_popcount",
              "carry_arbiter_1024ops": "carry_arbiter",
              "moe_dispatch_8192req_e16": "moe_dispatch",
              "fft4096_radix4_b4": "fft_stage",
              "banked_transpose_512": "banked_transpose"}


#: calls of each row's kernel in a bench run: one checked against the
#: plain version, 10 warm-up and 200 timed calls, one warm-up and 100
#: captured calls of the CUDA graph (``kernel_bench.rows``)
BENCH_CALLS = 1 + 10 + 200 + 1 + 100


def phase_bench() -> dict:
    """The kernel micro-bench through its CLI entry point on the card: six
    rows in the reference's order, each bit-equal to its plain version
    (err 0), each row's kernel launched."""
    import torch

    from repro_torch.bench import kernel_bench as KB
    entries = _entries()
    for e in entries.values():
        e.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = KB.main([])                            # prints the rows
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {name: e.launches for name, e in entries.items()}
    log(f"[bench] {len(rows)} rows through the CLI on the card in "
        f"{secs:.2f} s; launches on the path: {launches}")
    names = [r["name"] for r in rows]
    if names != list(BENCH_ROWS):
        raise AssertionError(f"bench rows {names} != {list(BENCH_ROWS)}")
    if any(r["err"] != 0 for r in rows):
        raise AssertionError(f"bench err: {[r['err'] for r in rows]}")
    missed = [k for k in BENCH_ROWS.values() if launches[k] == 0]
    if missed:
        raise AssertionError(f"the bench never launched {missed}")
    one_a_call = {k: launches[k] for k in ("conflict_popcount",
                                           "carry_arbiter", "moe_dispatch")}
    if set(one_a_call.values()) != {BENCH_CALLS}:
        raise AssertionError(f"launches {one_a_call}: not one a call of "
                             f"the bench's {BENCH_CALLS}")
    return {"rows": rows, "launches": launches, "seconds": secs}


POPCOUNT_TIMING = (1 << 20, 16)     # ops, banks: 138,412,032 bytes moved
ARBITER_TIMING = (1 << 18, 16)      # ops, banks: 570,425,344 bytes moved


def phase_controller_times() -> dict:
    """Both controller kernels at the bench's shape and at a shape where
    bytes, not the launch, set the time; held to the plain version first."""
    import torch

    from repro_torch.bench.kernel_bench import bound_ms, graph_ms, timed
    from repro_torch.kernels.carry_arbiter.ops import (ARBITER,
                                                       arbiter_words,
                                                       carry_arbiter,
                                                       carry_arbiter_plain)
    from repro_torch.kernels.conflict_popcount.ops import (
        POPCOUNT, conflict_popcount, conflict_popcount_plain)
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {"conflict_popcount": {}, "carry_arbiter": {}}
    err = {"conflict_popcount": 0.0, "carry_arbiter": 0.0}
    for n in (4096, POPCOUNT_TIMING[0]):
        b = POPCOUNT_TIMING[1]
        banks = torch.randint(0, b, (n, 16), device="cuda", generator=gen,
                              dtype=torch.int32)
        _held("conflict_popcount", POPCOUNT, f"({n}, 16) B={b}",
              lambda: conflict_popcount(banks, b),
              lambda: conflict_popcount_plain(banks, b), err)
        # (n, 16) int32 ids in; (n, b) counts and n cycles out
        out["conflict_popcount"][n] = timed(
            lambda: conflict_popcount(banks, b),
            lambda: conflict_popcount_plain(banks, b), None,
            bound_ms(n * 16 * 4 + n * b * 4 + n * 4), graph_iters=20,
            iters=50)
    for n in (1024, ARBITER_TIMING[0]):
        b = ARBITER_TIMING[1]
        reqs = torch.randint(0, 2 ** 16, (n, b), device="cuda", generator=gen)
        words = reqs.to(torch.int32)
        _held("carry_arbiter", ARBITER, f"({n}, {b})",
              lambda: carry_arbiter(reqs),
              lambda: carry_arbiter_plain(reqs), err)
        # the function's bytes: (n, b) 32-bit words in, (n, 16, b) out
        r = timed(lambda: carry_arbiter(reqs),
                  lambda: carry_arbiter_plain(reqs), None,
                  bound_ms(n * b * 4 + n * 16 * b * 4), graph_iters=20,
                  iters=50)
        # the wrapper's contract on the port's int64 words (8 bytes in and
        # 16 x 8 out a word), and the kernel alone on 32-bit words
        r["contract_bound_ms"] = bound_ms(n * b * 8 + n * 16 * b * 8)[0]
        r["kernel_device_ms"] = graph_ms(lambda: arbiter_words(words), 20)
        out["carry_arbiter"][n] = r
    for name, shapes in out.items():
        for n, r in shapes.items():
            us = {k: (v * 1e3 if isinstance(v, float) else v)
                  for k, v in r.items() if k.endswith("ms")}
            alone = ""
            if "kernel_device_ms" in us:
                alone = (f"; {100 * r['contract_bound_ms'] / r['device_ms']:.1f}"
                         f" % of the int64 contract's bound "
                         f"{us['contract_bound_ms']:.3f} us; the kernel alone "
                         f"on 32-bit words {us['kernel_device_ms']:.3f} us")
            log(f"[times] {name} at {n} ops: per call from Python: kernel "
                f"{us['ms']:.2f} us, plain {us['plain_ms']:.2f} us; device "
                f"time in a CUDA graph: kernel {us['device_ms']:.3f} us, "
                f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of the bound "
                f"{us['bound_ms']:.3f} us ({r['bound_by']}){alone}; "
                f"library: none")
    return {"shapes": out, "max_abs_err": err}


DISPATCH_BIG = 1 << 24               # requests: 150,994,944 bytes moved


def _held_dispatch(what, experts, n_experts, capacity, err, tag) -> None:
    """One dispatch call against its plain version on the same CUDA ids:
    ``pos`` and ``kept`` bit-equal (integers: tolerance 0), and one launch
    a pass of up to 1024 experts (one with no experts)."""
    import torch

    from repro_torch.kernels.moe_dispatch.ops import (DISPATCH, EXPERT_CHUNK,
                                                      moe_dispatch_plain,
                                                      moe_dispatch_positions)
    before = DISPATCH.launches
    got = moe_dispatch_positions(experts, n_experts, capacity)
    ran = DISPATCH.launches - before
    want = moe_dispatch_plain(experts, n_experts, capacity)
    torch.cuda.synchronize()
    same = all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want, strict=True))
    e = max((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
            for g, w in zip(got, want))
    err["moe_dispatch"] = max(err["moe_dispatch"], float(e))
    expect = max(-(-n_experts // EXPERT_CHUNK), 1)
    log(f"[{tag}] moe_dispatch, {what}: bit-equal to plain: {same}, "
        f"launches {ran}")
    if not same or ran != expect:
        raise AssertionError(f"moe_dispatch at {what}: equal {same}, max "
                             f"|diff| {e}, launches {ran} != {expect}")


def _dispatch_replays(err) -> int:
    """A dispatch captured in a CUDA graph (2^20 requests, E = 128) on a
    side stream, after an eager call there (which makes that stream's
    workspace), and replayed 5 times, new ids copied in before each replay
    and an eager call of another shape after it: each replay and each
    eager call bit-equal to the plain version.  Then two more graphs on
    that stream's workspace, the second replayed before the first has
    ever run, then the first, then the second: each bit-equal."""
    import torch

    from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                      moe_dispatch_positions)
    gen = torch.Generator(device="cuda").manual_seed(9)
    ids = torch.randint(0, 128, (1 << 20,), device="cuda", generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe_dispatch_positions(ids, 128, 5000)             # warm-up, eager
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        pos, kept = moe_dispatch_positions(ids, 128, 5000)
    for step in range(5):
        ids.copy_(torch.randint(0, 128, ids.shape, device="cuda",
                                generator=gen))
        graph.replay()
        other = torch.randint(-2, 20, (8192,), device="cuda", generator=gen)
        got = moe_dispatch_positions(other, 16, 300)
        want = moe_dispatch_plain(ids, 128, 5000)
        want_other = moe_dispatch_plain(other, 16, 300)
        torch.cuda.synchronize()
        same = (torch.equal(pos, want[0]) and torch.equal(kept, want[1])
                and all(torch.equal(g, w) for g, w in zip(got, want_other)))
        e = max((pos.long() - want[0].long()).abs().max().item(),
                (got[0].long() - want_other[0].long()).abs().max().item())
        err["moe_dispatch"] = max(err["moe_dispatch"], float(e))
        log(f"[dispatch] moe_dispatch, CUDA graph replay {step + 1} of 5 "
            f"(2^20 requests, E=128) and an eager call between: bit-equal "
            f"to plain: {same}")
        if not same:
            raise AssertionError(f"replay {step + 1}: max |diff| {e}")
    a = torch.randint(0, 16, (1 << 18,), device="cuda", generator=gen)
    b = torch.randint(-2, 40, (3 * 8192,), device="cuda", generator=gen)
    graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
    with torch.cuda.graph(graphs[0], stream=side):
        outs = [moe_dispatch_positions(a, 16, 9000)]
    with torch.cuda.graph(graphs[1], stream=side):
        outs.append(moe_dispatch_positions(b, 37, 300))
    wants = [moe_dispatch_plain(a, 16, 9000), moe_dispatch_plain(b, 37, 300)]
    for g in (1, 0, 1):
        graphs[g].replay()
        torch.cuda.synchronize()
        same = all(torch.equal(o, w) for o, w in zip(outs[g], wants[g]))
        e = (outs[g][0].long() - wants[g][0].long()).abs().max().item()
        err["moe_dispatch"] = max(err["moe_dispatch"], float(e))
        log(f"[dispatch] moe_dispatch, graph {g + 1} of two on one "
            f"workspace replayed (order 2, 1, 2): bit-equal to plain: {same}")
        if not same:
            raise AssertionError(f"graph {g + 1}: max |diff| {e}")
    return 5 + 3


def phase_dispatch() -> dict:
    """The dispatch kernel against its plain version on the card: the CPU
    tests' cases (tests/test_torch_dispatch.py: the reference tests' sweep
    and block boundary, the edge cases, several passes of experts), 2^24
    requests at E = 16 and E = 128, and graph replays; every call's
    launches counted."""
    import torch

    rng = np.random.default_rng(7)
    err = {"moe_dispatch": 0.0}

    def ids(lo, hi, r):
        return torch.as_tensor(rng.integers(lo, hi, r).astype(np.int32),
                               device="cuda")
    cases = [(f"sweep R={r} E={e} cap={c}", ids(0, e, r), e, c)
             for r, e, c in ((512, 16, 40), (1024, 8, 100), (2048, 16, 16))]
    cases += [
        ("1536 zeros, E=4, cap=1000 (three 512-blocks)",
         torch.zeros(1536, dtype=torch.int32, device="cuda"), 4, 1000),
        ("R=300, E=16, cap=20", ids(0, 16, 300), 16, 20),
        ("E=1, int64 ids", ids(0, 1, 1024).long(), 1, 700),
        ("E=256, cap=10", ids(0, 256, 2048), 256, 10),
        ("ids in [-4, 20), E=16", ids(-4, 20, 512), 16, 5),
        ("capacity 0", ids(0, 8, 512), 8, 0),
        ("capacity 5000 > R", ids(0, 8, 1024), 8, 5000),
        ("capacity int32 min", ids(0, 8, 64), 8, -2 ** 31),
        ("capacity int32 max", ids(0, 8, 64), 8, 2 ** 31 - 1),
        ("E=0: every id out of range", ids(-2, 3, 100), 0, 1),
        ("E=3000: three passes of experts, ids in [-3, 3003)",
         ids(-3, 3003, 8192), 3000, 3),
        ("E=32 (lane columns), three tiles", ids(0, 32, 3 * 8192), 32, 500),
        ("E=33 (ballot rows), ids in [-2, 36)", ids(-2, 36, 33 * 512), 33,
         100),
        ("int64 ids beyond int32 (low 32 bits count)",
         ids(-3, 19, 8192).long() + torch.as_tensor(
             rng.integers(-4, 5, 8192) * 2 ** 32, device="cuda"), 16, 300),
        ("R=2^24, E=16, cap=2^20", ids(0, 16, DISPATCH_BIG), 16, 1 << 20),
        ("R=2^24, E=128, cap=2^17", ids(0, 128, DISPATCH_BIG), 128,
         1 << 17),
        ("R=2^24, E=128, cap=2^17, int64 ids",
         ids(0, 128, DISPATCH_BIG).long(), 128, 1 << 17),
    ]
    for what, experts, e, cap in cases:
        _held_dispatch(what, experts, e, cap, err, "dispatch")
    n_cases = len(cases)
    cases.clear()                     # the 2^24 inputs
    torch.cuda.empty_cache()
    replays = _dispatch_replays(err)
    return {"max_abs_err": err, "cases": n_cases, "graph_replays": replays}


#: the timing shapes: (requests, experts, capacity)
DISPATCH_TIMING = ((8192, 16, 1024), (DISPATCH_BIG, 16, 1 << 20),
                   (DISPATCH_BIG, 128, 1 << 17))


def phase_dispatch_times() -> dict:
    """The dispatch kernel at the bench's shape and at 2^24 requests (E =
    16 and 128), held to its plain version first: per call, device time in
    a CUDA graph, the device time of its one launch (torch.profiler) and
    the byte bound (4 bytes read, 4 + 1 written a request)."""
    import torch

    from repro_torch.bench.kernel_bench import bound_ms, timed
    from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                      moe_dispatch_positions)
    gen = torch.Generator(device="cuda").manual_seed(8)
    out, err = {}, {"moe_dispatch": 0.0}
    for r, e, cap in DISPATCH_TIMING:
        experts = torch.randint(0, e, (r,), device="cuda", generator=gen,
                                dtype=torch.int32)
        _held_dispatch(f"R={r}, E={e}, cap={cap}", experts, e, cap, err,
                       "times")

        def call(experts=experts, e=e, cap=cap):
            return moe_dispatch_positions(experts, e, cap)
        t = timed(call, lambda experts=experts, e=e, cap=cap:
                  moe_dispatch_plain(experts, e, cap), None,
                  bound_ms(r * (4 + 4 + 1)), graph_iters=20, iters=50)
        # the device time of the one launch, and nothing else on the card
        launches = _profiled_kernels(lambda call=call: [call()
                                                         for _ in range(5)])
        durations = {}
        for ev in launches:
            durations.setdefault(ev.name, []).append(
                ev.time_range.elapsed_us() / 1e3)
        t["launch_counts"] = {k: len(v) for k, v in durations.items()}
        t["launch_device_ms"] = {k: sum(v) / len(v)
                                 for k, v in durations.items()}
        out[f"{r}x{e}"] = t
        us = {k: v * 1e3 for k, v in t.items()
              if k.endswith("ms") and isinstance(v, float)}
        split = ", ".join(f"{k[:40]} {v * 1e3:.3f} us"
                          for k, v in t["launch_device_ms"].items())
        log(f"[times] moe_dispatch at {r} requests, E={e}: per call from "
            f"Python: kernel {us['ms']:.2f} us, plain {us['plain_ms']:.2f} "
            f"us; device time in a CUDA graph: kernel {us['device_ms']:.3f} "
            f"us (1 launch), {100 * t['bound_ms'] / t['device_ms']:.1f} % "
            f"of the bound; the launch (torch.profiler, 5 calls): {split}; "
            f"bound {us['bound_ms']:.3f} us ({t['bound_by']}); library: "
            f"none")
        if list(t["launch_counts"].values()) != [5] or "dispatch_scan" not \
                in next(iter(t["launch_counts"])):
            raise AssertionError(f"the profiler saw {t['launch_counts']}, "
                                 f"not one dispatch launch a call")
    return {"shapes": out, "max_abs_err": err}


def phase_profile(engine) -> dict:
    """Where a decode step's time goes: ``torch.profiler`` over a short
    generation (3 decode steps) at the serving point."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prompts = np.random.default_rng(1).integers(
        0, engine.cfg.vocab_size, (BATCH, PROMPT))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(prompts, max_new_tokens=4)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device rows are the kernels (and copies) themselves; CPU ops also
    # carry their kernels' time, so only device rows are summed
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = [(e.key, e.count, e.self_device_time_total / 1e3,
             e.self_cpu_time_total / 1e3) for e in events]
    device_ms = sum(k[2] for k in kernels)
    busy = device_ms / (wall * 1e3)
    log(f"[profile] generate 4 tokens (prefill + 3 decode steps): wall "
        f"{wall * 1e3:.1f} ms (profiler on), device busy {device_ms:.1f} ms "
        f"= {100 * busy:.1f} % (idle {100 * (1 - busy):.1f} %)")
    for key, count, dev in sorted(kernels, key=lambda r: -r[2])[:10]:
        log(f"[profile]   device {dev:8.3f} ms  x{count:<5} {key[:80]}")
    for key, count, _, cpu in sorted(rows, key=lambda r: -r[3])[:8]:
        log(f"[profile]   host   {cpu:8.3f} ms  x{count:<5} {key[:80]}")
    return {"wall_ms": wall * 1e3, "device_ms": device_ms,
            "busy_share": busy, "n_kernel_launches": sum(k[1] for k in
                                                         kernels),
            "top_device": sorted(kernels, key=lambda r: -r[2])[:25],
            "top_host": sorted(rows, key=lambda r: -r[3])[:25]}


#: the whole decode steps the prover holds to the card's engine: batch 4,
#: prompt 64, the full configs (jamba runs all three traffic kernels)
ANALYSIS_MODELS = ("llama3.2-1b", "jamba-v0.1-52b")
#: Tables II and III at the paper's sizes
ANALYSIS_TRANSPOSES = (32, 64, 128)
ANALYSIS_FFTS = ((4096, 4), (4096, 8), (4096, 16))


def _timed(fn):
    """(result, host seconds to the end of the device work)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _analysis_oracle() -> dict:
    """The paged cache's plain-torch oracle (``append_token`` /
    ``gather_kv``) on the card against the single-table row kernels
    (``gather_pages`` / ``scatter_pages``): llama3.2-1b's KV shape (8 heads
    x 64, bf16) on a 16B pool of 8-token pages, 4 sequences of 80 tokens.
    Returns the kernels' launches (counted from 0 here) and the largest
    difference (tolerance 0)."""
    import torch

    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels.banked_scatter import ops as S
    from repro_torch.serving.kvcache import (PagedKVConfig, append_token,
                                             gather_kv, gather_pages,
                                             init_state, pool_pages,
                                             pool_rows, scatter_pages)

    n_seq, n_tok = BATCH, PROMPT + NEW
    cfg = PagedKVConfig.from_arch(
        "16B", n_pages=pool_pages(16, n_seq, n_tok, PAGE_LEN),
        page_len=PAGE_LEN, kv_heads=8, head_dim=64)
    gen = torch.Generator(device="cuda").manual_seed(7)
    kv = torch.randn((2, n_tok, n_seq, 8, 64), generator=gen,
                     device="cuda").to(torch.bfloat16)
    state = init_state(cfg, n_seq, n_tok, device="cuda")
    for t in range(n_tok):
        state = append_token(cfg, state, kv[0, t], kv[1, t])
    k, v, valid = gather_kv(cfg, state, n_tok)
    n_pages = -(-n_tok // PAGE_LEN)
    ids = state.pages.page_table[:, :n_pages].reshape(-1).contiguous()
    G.GATHERS.launches = S.SCATTERS.launches = 0
    shape = (n_seq, n_tok, 8, 64)
    got = [gather_pages("16B", cfg, pool_rows(pool), ids).reshape(shape)
           for pool in (state.k_pool, state.v_pool)]
    back = [scatter_pages("16B", cfg, torch.zeros_like(pool_rows(pool)),
                          ids, pool_rows(pool)[cfg.layout.physical_row(
                              ids, cfg.n_pages)])
            for pool in (state.k_pool, state.v_pool)]
    torch.cuda.synchronize()
    launches = {"banked_gather": G.GATHERS.launches,
                "banked_scatter": S.SCATTERS.launches}
    entries = {"banked_gather": G.GATHERS.by_entry(),
               "banked_scatter": S.SCATTERS.by_entry()}
    want_k = kv[0].transpose(0, 1)
    err = max(
        (got[0].float() - k.float()).abs().max().item(),
        (got[1].float() - v.float()).abs().max().item(),
        (k.float() - want_k.float()).abs().max().item(),
        (v.float() - kv[1].transpose(0, 1).float()).abs().max().item(),
        (back[0].float() - pool_rows(state.k_pool).float()).abs().max()
        .item(),
        (back[1].float() - pool_rows(state.v_pool).float()).abs().max()
        .item())
    ok = (bool(valid.all()) and err == 0 and (ids >= 0).all().item()
          and launches == {"banked_gather": 2, "banked_scatter": 2})
    log(f"[analysis] oracle: {n_seq} x {n_tok} tokens of 8 x 64 bf16 K/V "
        f"appended by append_token on a 16B pool of {cfg.n_pages} "
        f"{PAGE_LEN}-token pages; gather_kv == gather_pages and scattered "
        f"lines == the oracle's pool: max |diff| {err} (tolerance 0); "
        f"launches {launches}, by entry {entries}")
    if not ok:
        raise AssertionError(f"the paged oracle disagrees with the row "
                             f"kernels: err {err}, launches {launches}")
    return {"launches": launches, "entries": entries, "max_abs_err": err}


def _analysis_scaled_embedding() -> dict:
    """gemma2's smoke config with ``embed_scale`` on, served in float32 on
    the card and on the host from the same seeded weights, paged and
    dense: the decode steps embed the token unscaled as the reference's
    do, and the card's tokens must equal the host's (argmaxes of float32
    logits; TF32 off for the run)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import init_tree, model_specs
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"),
                              embed_scale=True)
    rc = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
    host = init_tree(model_specs(cfg), torch.Generator().manual_seed(3),
                     device="cpu")
    card = tree_map(lambda x: x.to("cuda"), host)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 10))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tokens = {
            (mode, dev): ServeEngine(
                cfg, rc, params, kv_mode=mode, max_batch=3, max_seq=24,
                page_len=8, device=dev).generate(
                    prompts, max_new_tokens=6).tokens.tolist()
            for mode in ("paged", "dense")
            for dev, params in (("cuda", card), ("cpu", host))}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    same = all(tokens[(m, "cuda")] == tokens[(m, "cpu")]
               for m in ("paged", "dense"))
    log(f"[analysis] gemma2-9b smoke with embed_scale=True, float32, 3 x 10 "
        f"prompt + 6 tokens: card tokens == host tokens, paged and dense: "
        f"{same}")
    if not same:
        raise AssertionError(f"gemma2's scaled-embedding generation differs "
                             f"between the card and the host: {tokens}")
    return {"same_tokens": same, "tokens": tokens[("paged", "cuda")]}


def phase_analysis(engine, serve: dict, smi: str) -> dict:
    """The analysis layer and the online tuner on the serving engine, the
    prover against the card's engine at full width, the analysis CLI, and
    the paged cache's oracle against the row kernels (see the module
    docstring)."""
    import importlib

    from repro_torch.analysis import validate
    from repro_torch.core import cost_engine as CE

    t_phase = time.perf_counter()

    # (1) the serving point once more through the paired row kernels
    prompts = np.random.default_rng(0).integers(0, engine.cfg.vocab_size,
                                                (BATCH, PROMPT))
    n_kv, steps = engine.n_kv_layers, NEW - 1
    res, gen_s, launches, entries = _counted_path(
        "analysis", lambda: engine.generate(prompts, max_new_tokens=NEW),
        lambda _: {"banked_gather": n_kv * steps,
                   "banked_scatter": n_kv * steps + n_kv})
    same_tokens = res.tokens.tolist() == serve["tokens"]
    rep = validate(engine.serving_stream(include_prefill=True), "16B")
    log(f"[analysis] generation: {gen_s:.3f} s, tokens equal to the serve "
        f"phase's: {same_tokens}; serving_stream valid on 16B: "
        f"{rep.n_blocks} blocks, {rep.n_ops} ops, {rep.n_instructions} "
        f"instructions")
    if not same_tokens:
        raise AssertionError("the generation's tokens differ from serve's")

    # every ``cost_many`` call of sections (2)-(4) is counted and timed:
    # the tuners call it by module attribute, the prover's cross_check
    # imports it when called (``repro_torch.tune.online`` is the module; the
    # package's attribute of that name is the function)
    TO = importlib.import_module("repro_torch.tune.online")
    calls = {"cost_many": 0, "cost_many_s": []}

    def counted(*args, **kw):
        calls["cost_many"] += 1
        out, secs = _timed(lambda: real(*args, **kw))
        calls["cost_many_s"].append(secs)
        return out
    real, CE.cost_many, TO.cost_many = CE.cost_many, counted, counted
    try:
        return _analysis_sections(engine, launches, entries, gen_s, steps,
                                  calls, t_phase, smi)
    finally:
        CE.cost_many = TO.cost_many = real


def _analysis_sections(engine, launches, entries, gen_s, steps, calls,
                       t_phase, smi) -> dict:
    """Sections (2)-(5) of the ``analysis`` phase."""
    import io
    import os

    from repro_torch import tune
    from repro_torch.analysis import __main__ as CLI
    from repro_torch.analysis.symbolic import cross_check, prove
    from repro_torch.core import arch as A
    from repro_torch.core.trace import AddressTrace
    from repro_torch.isa.programs import fft as fft_prog
    from repro_torch.isa.programs import transpose as tr_prog
    from repro_torch.models.trace import (model_step_symbolic,
                                          model_step_trace)

    # (2) the online tuner over the decode steps, card against host
    card = tune.online(engine, window=8, device="cuda")
    host = tune.online(engine, window=8, device="cpu")
    step_s, host_s, hit_rate = [], [], []
    for i in range(steps):
        trace = engine.step_trace(i)
        before = dict(card.cache.stats)
        rec, secs = _timed(lambda: card.step(trace))
        step_s.append(secs)
        t0 = time.perf_counter()
        want = host.step(trace)
        host_s.append(time.perf_counter() - t0)
        if rec != want:
            raise AssertionError(f"step {i}: the card tuner recommends "
                                 f"{rec}, the host tuner {want}")
        d_hits = card.cache.stats["hits"] - before["hits"]
        d_miss = card.cache.stats["misses"] - before["misses"]
        hit_rate.append(d_hits / max(1, d_hits + d_miss))
    full = card.reprice(full_rebuild=True)
    inc = card.reprice()
    if full != inc:
        raise AssertionError("full rebuild != incremental re-price")
    tuner_calls = calls["cost_many"]
    log(f"[analysis] tune.online(engine, window=8) over PAPER_SPACE "
        f"({len(card.archs)} memories), {steps} decode steps: recommend() "
        f"equal to the host tuner's at every step (winner {rec['winner']}, "
        f"current {rec['current']}, swap {rec['swap']}, streak "
        f"{rec['streak']}, cache {rec['cache']}); full rebuild == "
        f"incremental: True; tuner.step() host time cold "
        f"{1e3 * step_s[0]:.3f} ms, warm median "
        f"{1e3 * float(np.median(step_s[1:])):.3f} ms (host tuner cold "
        f"{1e3 * host_s[0]:.3f} ms, warm median "
        f"{1e3 * float(np.median(host_s[1:])):.3f} ms); cache hit rate from "
        f"step 2 on {np.mean(hit_rate[1:]):.4f}; {tuner_calls} cost_many "
        f"calls, {smi}")

    # (3) the prover against the card's engine under ``cross_check``, whole
    # decode steps at full width and the paper's tables; the prover's host
    # time is cross_check's less its one ``cost_many`` call's
    archs = [A.get(n) for n in CLI.PROVE_ARCHS]
    points = {}

    def held(label, sym, trace):
        first = len(calls["cost_many_s"])
        _, secs = _timed(lambda: cross_check(archs, sym, trace,
                                             device="cuda"))
        (cost_s,) = calls["cost_many_s"][first:]
        prove_s = secs - cost_s
        points[label] = {"prove_s": prove_s, "cost_many_s": cost_s,
                         "n_ops": sym.n_ops, "families": len(sym.families)}
        log(f"[analysis] {label}: cross_check passed on {len(archs)} archs "
            f"(bit-exact, engine on the card); {sym.n_ops} ops in "
            f"{len(sym.families)} families; prover (host) "
            f"{1e3 * prove_s:.3f} ms, cost_many on the card "
            f"{1e3 * cost_s:.3f} ms")

    for name in ANALYSIS_MODELS:
        held(f"model_step {name} b{BATCH} p{PROMPT}",
             model_step_symbolic(name, "16B", batch=BATCH,
                                 prompt_len=PROMPT, device="cuda"),
             model_step_trace(name, "16B", batch=BATCH, prompt_len=PROMPT,
                              device="cuda"))
    for n in ANALYSIS_TRANSPOSES:
        held(f"transpose {n}x{n}", tr_prog.symbolic_trace(n),
             AddressTrace.from_program(tr_prog.transpose_program(n)))
    for n, r in ANALYSIS_FFTS:
        held(f"fft {n} radix {r}", fft_prog.symbolic_trace(n, r),
             AddressTrace.from_program(fft_prog.fft_program(n, r)))
    sym64 = tr_prog.symbolic_trace(64)
    xor = prove(A.get("16B-xor"), sym64).family("transpose64 row loads")
    lsb = prove(A.get("16B"), sym64).family("transpose64 column stores")
    log(f"[analysis] facts: 16B-xor transpose loads conflict-free "
        f"{xor.conflict_free}; 16B lsb column stores "
        f"{lsb.max_cycles}-way serialized")
    if not xor.conflict_free or lsb.max_cycles != 16:
        raise AssertionError("a headline fact failed")

    # (4) the CLI with no arguments: lint of src, prove and check on cuda
    cwd = Path.cwd()
    text = io.StringIO()
    try:
        os.chdir(ROOT)
        with contextlib.redirect_stdout(text):
            rc, cli_s = _timed(lambda: CLI.main([]))
    finally:
        os.chdir(cwd)
    lines = text.getvalue().splitlines()
    for line in lines:
        log(f"[analysis] cli | {line}")
    log(f"[analysis] python -m repro_torch.analysis (no arguments): exit "
        f"{rc} in {cli_s:.3f} s")
    if rc != 0 or lines[-1:] != ["analysis: OK"]:
        raise AssertionError(f"the analysis CLI failed: {lines[-1:]}")

    # (5) the paged cache's oracle against the single-table row kernels,
    # and (6) gemma2's scaled embedding served on the card against the host
    oracle = _analysis_oracle()
    scaled = _analysis_scaled_embedding()

    wall = time.perf_counter() - t_phase
    log(f"[analysis] phase wall time {wall:.3f} s, {calls['cost_many']} "
        f"cost_many calls ({smi})")
    # the path's launches are the generation's; the oracle's check launches
    # are kept beside them, out of the path's count
    return {"launches": launches, "entries": entries,
            "oracle_launches": oracle["launches"],
            "oracle_entries": oracle["entries"],
            "max_abs_err": oracle["max_abs_err"], "scaled_embedding": scaled,
            "generate_s": gen_s,
            "tuner": {"steps": steps, "step_s": step_s,
                      "host_step_s": host_s, "hit_rate": hit_rate,
                      "cost_many_calls": tuner_calls,
                      "last": {k: rec[k] for k in ("winner", "current",
                                                   "swap", "streak",
                                                   "cache")}},
            "points": points, "cli_s": cli_s, "cli_lines": lines,
            "cost_many_calls": calls["cost_many"], "wall_s": wall}


#: an H100 SXM's dense bf16 peak (NVIDIA's data sheet, at 700 W)
BF16_PEAK_TFLOPS = 989.0
#: the long training step: ``train_4k``'s sequence (4096), its global batch
#: cut from 256 to 2 to fit one card
TRAIN_LONG = (2, 4096)
#: bf16 tolerances of the long step's flash-against-dense checks: one
#: layer's attention output within 2e-2 of its largest magnitude (about
#: five bf16 steps at the max), the loss within 5e-3 of itself
FLASH_ATTN_TOL, FLASH_LOSS_RTOL = 2e-2, 5e-3


def _profiled(fn) -> tuple:
    """``fn()`` under ``torch.profiler`` (CPU and CUDA); returns its
    result and the window's wall, device time by kernel, busy share and
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(k[2] for k in kernels)
    return out, {"wall_ms": wall * 1e3, "device_ms": device_ms,
                 "busy_share": device_ms / (wall * 1e3),
                 "launches": sum(k[1] for k in kernels),
                 "top_device": sorted(kernels, key=lambda r: -r[2])[:12]}


def _log_profile(tag: str, prof: dict, smi: str, phase="train") -> None:
    log(f"[{phase}] {tag} under torch.profiler: wall {prof['wall_ms']:.1f} "
        f"ms, device busy {prof['device_ms']:.1f} ms = "
        f"{100 * prof['busy_share']:.1f} %, {prof['launches']} kernel "
        f"launches ({smi})")
    for key, count, ms in prof["top_device"][:8]:
        log(f"[{phase}]   device {ms:9.3f} ms  x{count:<6} {key[:80]}")


def _recorded_steps(TR, steps: list, profile_at=None):
    """Patch ``TR.make_train_step`` (the trainer's) so each step is timed
    on the host to the end of its device work and its metrics kept, step
    ``profile_at`` under ``torch.profiler`` instead; returns the original
    to restore."""
    import torch
    original = TR.make_train_step

    def make(*args, **kw):
        step_fn = original(*args, **kw)

        def run(state, batch):
            state, met = step_fn(state, batch)
            return state, {k: float(v) for k, v in met.items()}

        def timed(state, batch):
            sizes = {"tokens": batch["tokens"].numel(),
                     "positions": batch["tokens"].numel() + (
                         batch["frontend"].shape[:2].numel()
                         if "frontend" in batch else 0)}
            if len(steps) == profile_at:
                (state, met), prof = _profiled(lambda: run(state, batch))
                steps.append({**met, "s": prof["wall_ms"] / 1e3, **sizes,
                              "profile": prof})
                return state, met
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = run(state, batch)
            torch.cuda.synchronize()
            steps.append({**met, "s": time.perf_counter() - t0, **sizes})
            return state, met
        return timed
    TR.make_train_step = make
    return original


def _run_steps(phase: str, tag: str, fn, n_active: int, smi: str,
               profile_at=None) -> tuple:
    """``fn()`` (a run of the trainer) with each train step timed and its
    metrics kept (``_recorded_steps``) and the peak device memory from
    zero; logs each step's time, tokens/s and model-FLOPs rate, 6 x
    ``n_active`` parameters x positions a second (frontend positions
    included), as a share of the bf16 peak.  Returns (fn's result, the
    steps, the peak in GB)."""
    import torch

    from repro_torch.train import trainer as TR
    steps = []
    original = _recorded_steps(TR, steps, profile_at)
    torch.cuda.reset_peak_memory_stats()
    try:
        out = fn()
    finally:
        TR.make_train_step = original
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, s in enumerate(steps):
        s["model_tflops"] = 6 * n_active * s["positions"] / s["s"] / 1e12
        log(f"[{phase}] {tag} step {i}: loss {s['loss']:.6g}, aux "
            f"{s['aux']:.6g}, lr {s['lr']:.6g}, grad_norm "
            f"{s['grad_norm']:.6g}, {s['s']:.4f} s = "
            f"{s['tokens'] / s['s']:.1f} tokens/s"
            f"{'' if s['positions'] == s['tokens'] else ' (%.1f positions/s)' % (s['positions'] / s['s'])}, "
            f"6·N·positions {s['model_tflops']:.2f} TFLOP/s = "
            f"{100 * s['model_tflops'] / BF16_PEAK_TFLOPS:.2f} % of "
            f"the bf16 peak ({smi})"
            f"{' (profiled)' if 'profile' in s else ''}")
        if "profile" in s:
            _log_profile(f"{tag} step {i}", s["profile"], smi, phase)
    log(f"[{phase}] {tag}: peak device memory {peak:.3f} GB "
        f"(torch.cuda.max_memory_allocated, {smi})")
    return out, steps, peak


def _moments_filled(state, seed: int):
    """``state`` with its moments as a running job's (m ~ 1e-3, sqrt(v) ~
    1e-2, drawn on the host from ``seed``) and its step 5, past the
    warmup, so the next update moves every parameter."""
    import torch

    from repro_torch.models.params import tree_map
    g = torch.Generator().manual_seed(seed)
    m = tree_map(lambda t: (1e-3 * torch.randn(t.shape, generator=g)).to(
        t.device), state.opt.m)
    v = tree_map(lambda t: (1e-4 * (0.5 + torch.rand(
        t.shape, generator=g))).to(t.device), state.opt.v)
    return state._replace(step=torch.full_like(state.step, 5),
                          opt=state.opt._replace(m=m, v=v))


def _card_vs_host_step(cfg, rc, ds) -> tuple:
    """One train step of ``cfg`` (a smoke config) on the card and the same
    step on the host, from one host state (parameters from a generator
    seeded 4, moments as a running job's) and ``ds``'s batch 0: returns
    the two steps' metrics and {"loss_rel", "aux_abs", "grad_norm_rel",
    "excess"}, the last the largest |card - host| - 1e-4 |host| over the
    updated parameters and moments."""
    import torch

    from repro_torch.models.params import leaves, tree_map
    from repro_torch.train import init_train_state
    from repro_torch.train.step import make_train_step

    host = _moments_filled(init_train_state(
        cfg, rc, torch.Generator().manual_seed(4), device="cpu"), 4)

    def to_card(tree):
        return None if tree is None else tree_map(
            lambda t: t.to("cuda", copy=True), tree)
    card = host._replace(step=to_card(host.step),
                         params=to_card(host.params),
                         opt=type(host.opt)(*map(to_card, host.opt)))
    fstep = make_train_step(cfg, rc)
    card, met_c = fstep(card, ds.batch(0, device="cuda"))
    host, met_h = fstep(host, ds.batch(0, device="cpu"))
    worst = 0.0
    for got, want in ((card.params, host.params), (card.opt.m, host.opt.m),
                      (card.opt.v, host.opt.v)):
        for g_, w_ in zip(leaves(got), leaves(want)):
            if w_.numel():
                excess = ((g_.cpu() - w_).abs() - 1e-4 * w_.abs()).max()
                worst = max(worst, excess.item())

    def rel(k):
        return abs(float(met_c[k]) - float(met_h[k])) / abs(float(met_h[k]))
    return met_c, met_h, {
        "loss_rel": rel("loss"), "grad_norm_rel": rel("grad_norm"),
        "aux_abs": abs(float(met_c["aux"]) - float(met_h["aux"])),
        "excess": worst}


def phase_train(smi: str) -> dict:
    """Training (slice 7a) on the card: (a) the train CLI
    (``repro_torch.launch.train.main``) at full width and depth,
    llama3.2-1b, 4 steps of global batch 16 x seq 64, dense attention;
    (b) a ``Trainer`` at full width with the ``RunConfig`` defaults
    (remat "full", attention "auto") at ``train_4k``'s sequence, batch cut
    to 2, 2 steps, through blocked flash attention; (c) from (b)'s state,
    one layer's attention and the step's loss under "flash" against
    "dense" (bf16 tolerances); (d) the smoke config's 10 straight steps
    against 5 + checkpoint under ``build/`` + resume + 5, rtol 1e-5; (e)
    one float32 train step of the smoke config on the card against the
    same step on the host.  Each step's time, tokens/s, model-FLOPs rate
    and the peak device memory are printed beside the card's name and
    power limit, with (a)'s last step and a third step of (b) under
    ``torch.profiler`` (busy share, kernels by device time); the path
    launches none of the seven kernels."""
    import contextlib
    import gc
    import io
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.models import count_params
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    entries = _entries()
    for e in entries.values():
        e.launches = 0
    cfg = get_config("llama3.2-1b")
    n_params = count_params(T.model_specs(cfg))
    checks, record = {}, {"nvidia_smi": smi, "n_params": n_params}
    log(f"[train] llama3.2-1b: {n_params} parameters (embedding once); "
        f"device memory before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated; "
        f"TF32 matmuls {torch.backends.cuda.matmul.allow_tf32}")

    def run_steps(tag, fn, profile_at=None):
        return _run_steps("train", tag, fn, n_params, smi, profile_at)

    # (a) the CLI's default step at full width and depth
    text = io.StringIO()

    def cli():
        with contextlib.redirect_stdout(text):
            return train_cli.main(["--arch", "llama3.2-1b", "--steps", "4"])
    _, steps_a, peak_a = run_steps("(a) CLI", cli, profile_at=3)
    losses = [s["loss"] for s in steps_a]
    checks["(a) 4 steps, finite losses"] = len(steps_a) == 4 and bool(
        np.isfinite(losses).all())
    checks["(a) lr 0 at step 0, then 1e-3"] = [s["lr"] for s in steps_a] == [
        0.0] + [float(np.float32(1e-3))] * 3
    checks["(a) first loss above ln V"] = bool(
        losses[0] > np.log(cfg.vocab_size))
    checks["(a) loss fell by step 3"] = losses[3] < losses[0]
    checks["(a) final printed"] = text.getvalue().startswith("final: {")
    record["cli"] = {"steps": steps_a, "peak_gb": peak_a}
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the long step: RunConfig defaults, flash through "auto"
    batch, seq = TRAIN_LONG
    rc = RunConfig()
    flash_calls = []
    flash = L.attention_flash

    def counted(*args):
        flash_calls.append(1)
        return flash(*args)
    L.attention_flash = counted
    try:
        ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
        out_b, steps_b, peak_b = run_steps(f"(b) {batch} x {seq}", lambda: Trainer(
            cfg, rc, TrainerConfig(total_steps=2, log_every=1), ds,
            device="cuda").run())
    finally:
        L.attention_flash = flash
    # each step: the forward and remat "full"'s recompute, a call a layer
    want_flash = 2 * 2 * cfg.n_layers
    checks["(b) 2 finite steps"] = len(steps_b) == 2 and bool(
        np.isfinite([s["loss"] for s in steps_b]).all())
    checks["(b) flash ran, forward + recompute"] = (
        len(flash_calls) == want_flash)
    record["long"] = {"steps": steps_b, "peak_gb": peak_b,
                      "flash_calls": len(flash_calls),
                      "remat": rc.remat, "attn_impl": rc.attn_impl,
                      "batch": batch, "seq": seq}

    # a third step of (b)'s run, under the profiler
    _, prof_b = _profiled(lambda: make_train_step(cfg, rc, total_steps=2)(
        out_b["state"], ds.batch(2, device="cuda")))
    _log_profile(f"(b) {batch} x {seq} step 2", prof_b, smi)
    record["long"]["profile"] = prof_b

    # (c) flash against dense from (b)'s state, the next batch
    params = out_b["state"].params
    del out_b
    gc.collect()
    torch.cuda.empty_cache()
    tokens = ds.batch(3, device="cuda")
    with torch.no_grad():
        p0 = T.superblock_params(params, 0, 0)
        x = L.rmsnorm(p0["ln1"], T._embed(
            cfg, params, tokens["tokens"], None, torch.bfloat16), cfg.norm_eps)
        outs = {impl: L.attention(cfg, RunConfig(attn_impl=impl), p0[
            "mixer"], x).float() for impl in ("flash", "dense")}
        attn_err = (outs["flash"] - outs["dense"]).abs().max().item()
        attn_scale = outs["dense"].abs().max().item()
        del outs, x
        loss = {impl: float(T.loss_fn(cfg, RunConfig(attn_impl=impl),
                                      params, tokens)[1]["loss"])
                for impl in ("flash", "dense")}
    loss_err = abs(loss["flash"] - loss["dense"])
    log(f"[train] (c) {batch} x {seq}, flash vs dense: layer 0 attention max "
        f"|diff| {attn_err:.6g} of max |out| {attn_scale:.6g} (tolerance "
        f"{FLASH_ATTN_TOL} of it); loss {loss['flash']:.8g} vs "
        f"{loss['dense']:.8g}, |diff| {loss_err:.6g} (rtol "
        f"{FLASH_LOSS_RTOL})")
    checks["(c) attention flash == dense (bf16)"] = (
        attn_err <= FLASH_ATTN_TOL * attn_scale)
    checks["(c) loss flash == dense (bf16)"] = (
        loss_err <= FLASH_LOSS_RTOL * abs(loss["dense"]))
    record["flash_vs_dense"] = {"attn_max_abs_diff": attn_err,
                                "attn_max_abs": attn_scale, "loss": loss}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) resume == straight on the smoke config, checkpoint under build/
    smoke = get_smoke_config("llama3.2-1b")
    rc_s = RunConfig(remat="none", attn_impl="dense", learning_rate=3e-3,
                     warmup_steps=5)
    ds_s = SyntheticLM(vocab_size=smoke.vocab_size, seq_len=32,
                       global_batch=8, seed=3, branching=2)
    (ROOT / "build").mkdir(exist_ok=True)

    def resumed_vs_straight():
        ck = tempfile.mkdtemp(prefix="train_", dir=ROOT / "build")
        try:
            straight = Trainer(smoke, rc_s, TrainerConfig(
                total_steps=10, log_every=1), ds_s,
                device="cuda").run()["final"]["loss"]
            Trainer(smoke, rc_s, TrainerConfig(
                total_steps=5, ckpt_dir=ck, ckpt_every=5, log_every=1),
                ds_s, device="cuda").run()
            resumed = Trainer(smoke, rc_s, TrainerConfig(
                total_steps=10, ckpt_dir=ck, ckpt_every=50, log_every=1),
                ds_s, device="cuda").run()["final"]["loss"]
        finally:
            shutil.rmtree(ck, ignore_errors=True)
        return straight, resumed, abs(resumed - straight) / abs(straight)

    free = resumed_vs_straight()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = resumed_vs_straight()
    finally:
        torch.use_deterministic_algorithms(False)
    log(f"[train] (d) smoke resume vs straight, 10 steps: default "
        f"algorithms {free[1]:.9g} vs {free[0]:.9g} (rel {free[2]:.3g}); "
        f"deterministic algorithms {det[1]:.9g} vs {det[0]:.9g} (rel "
        f"{det[2]:.3g}; rtol 1e-5 gates this one)")
    checks["(d) resumed == straight (deterministic, rtol 1e-5)"] = (
        det[2] <= 1e-5)
    record["resume"] = {"default": free, "deterministic": det}

    # (e) one float32 step on the card against the same step on the host
    rc_f = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32",
                     warmup_steps=2, learning_rate=3e-3)
    met_c, met_h, cmp = _card_vs_host_step(smoke, rc_f, ds_s)
    log(f"[train] (e) float32 smoke step, card vs host: loss "
        f"{float(met_c['loss']):.9g} vs {float(met_h['loss']):.9g} (rel "
        f"{cmp['loss_rel']:.3g}, rtol 1e-5); params, m, v: max(|diff| - 1e-4 "
        f"|host|) {cmp['excess']:.3g} (atol 1e-6)")
    checks["(e) card step == host step (f32)"] = (
        cmp["loss_rel"] <= 1e-5 and cmp["excess"] <= 1e-6)
    record["card_vs_host"] = {"loss_rel": cmp["loss_rel"],
                              "excess": cmp["excess"]}

    launches = {name: e.launches for name, e in entries.items()}
    checks["no kernel launched"] = not any(launches.values())
    wall = time.perf_counter() - t_phase
    log(f"[train] phase wall time {wall:.2f} s ({smi}); kernel launches "
        f"{launches}; checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"train checks failed: {checks}")
    return {**record, "checks": checks, "launches": launches,
            "wall_s": wall}


#: the full-width family points: (arch, layers kept).  jamba keeps one
#: superblock of its 32 layers (7 Mamba + 1 attention, MoE on every
#: second), 13.3 G parameters (53 GB in f32; the whole 206 GB does not fit
#: one card); falcon-mamba keeps all 64 layers (7.3 G parameters, 29 GB)
FAMILY_POINTS = (("jamba-v0.1-52b", 8), ("falcon-mamba-7b", 64))
#: the smoke configs of the four families, held card against host
FAMILY_SMOKES = ("falcon-mamba-7b", "jamba-v0.1-52b", "mixtral-8x22b",
                 "phi3.5-moe-42b-a6.6b")
#: float32 card-against-host tolerance of the smoke logits, as a share of
#: the largest logit's magnitude (the two devices sum in other orders;
#: TF32 is off)
FAMILY_LOGIT_TOL = 1e-5


def _family_point(arch: str, n_layers: int, smi: str, check=None) -> dict:
    """One full-width point: random f32 weights from seed 0, bf16 compute,
    ``generate`` of BATCH requests x PROMPT + NEW tokens on 8-token pages
    of a 16B pool through ``_counted_path`` (the KV layers' paired row
    launches as the path implies, none of a plain version); the same run
    with the row entries forced to their plain versions (tokens and every
    decode-state leaf equal, tolerance 0); a prefill timed alone; one
    decode step under ``torch.profiler``.  Jamba's first MoE layer's
    router stream (prefill, one group) goes through the dispatch kernel
    against the registry's ``ref``, bit-equal.  ``check(params)``, if
    given, runs on the point's weights before they are freed; its result
    is the point's ``check``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels import registry
    from repro_torch.kernels.banked_scatter import ops as S
    from repro_torch.kernels.moe_dispatch import ops as D
    from repro_torch.models import init_tree, model_specs
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.params import count_params
    from repro_torch.serving import kvcache as KV
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    rc = RunConfig(remat="none", attn_impl="dense")
    specs = model_specs(cfg)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_tree(specs, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the serving peak: weights made (init's own peak holds a stacked
    # leaf twice), then everything serving adds on top
    weights_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    n_params = count_params(specs)
    engine = ServeEngine(cfg, rc, params, max_batch=BATCH, max_seq=MAX_SEQ,
                         mem_arch="16B", page_len=PAGE_LEN, device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (BATCH, PROMPT))
    engine.generate(prompts, max_new_tokens=2)       # warm-up (cuBLAS etc.)
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.prefill(cfg, rc, params, toks)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0

    n_kv, steps = engine.n_kv_layers, NEW - 1
    step_s = []
    paged_step = engine._paged_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = paged_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out
    engine._paged_step = timed_step
    try:
        res, secs, launches, entries = _counted_path(
            f"families {arch}",
            lambda: engine.generate(prompts, max_new_tokens=NEW),
            lambda _: {"banked_gather": n_kv * steps,
                       "banked_scatter": n_kv * steps + n_kv})
    finally:
        del engine._paged_step
    tokens = res.tokens
    if tokens.shape != (BATCH, NEW) or tokens.min() < 0 or (
            tokens.max() >= cfg.vocab_size):
        raise AssertionError(f"[families] {arch}: bad tokens "
                             f"{tokens.shape} [{tokens.min()}, "
                             f"{tokens.max()}]")
    state = engine.last_pools

    # the same generation through the plain row versions: tolerance 0
    kernels = KV.banked_gather_pair, KV.banked_scatter_pair
    KV.banked_gather_pair, KV.banked_scatter_pair = _plain_pairs(G, S)
    G.GATHERS.launches = S.SCATTERS.launches = 0
    try:
        plain = engine.generate(prompts, max_new_tokens=NEW)
    finally:
        KV.banked_gather_pair, KV.banked_scatter_pair = kernels
    plain_launches = G.GATHERS.launches + S.SCATTERS.launches
    torch.cuda.synchronize()
    same_state = all(torch.equal(a[name], b[name])
                     for a, b in zip(state.values(),
                                     engine.last_pools.values())
                     for name in a)
    n_leaves = sum(len(a) for a in state.values())
    log(f"[families] {arch}: the generation with the row entries forced "
        f"to their plain versions ({plain_launches} kernel launches): "
        f"tokens equal {np.array_equal(tokens, plain.tokens)}, all "
        f"{n_leaves} decode-state leaves (K/V pools, SSM h and conv) equal "
        f"{same_state} (tolerance 0)")
    if plain_launches or not same_state or not np.array_equal(
            tokens, plain.tokens):
        raise AssertionError(f"[families] {arch}: the kernels' generation "
                             f"differs from the plain one")
    del state, plain

    # one decode step under the profiler, from the run's final state
    pos = PROMPT + NEW - 1
    tok = torch.as_tensor(tokens[:, -1:], device="cuda")
    with torch.inference_mode():
        _, prof = _profiled(lambda: engine._paged_step(
            params, tok, engine.last_pools, engine.last_pages, pos))
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[families] {arch} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params:,} parameters, "
        f"{4 * n_params / 1e9:.2f} GB f32; {n_kv} KV layers): weights made "
        f"in {init_s:.3f} s; {BATCH} requests x {PROMPT} prompt + {NEW} new "
        f"tokens in {secs:.3f} s = {BATCH * NEW / secs:.1f} tokens/s "
        f"(prefill included); prefill alone {prefill_s * 1e3:.2f} ms; a "
        f"decode step median {np.median(step_s) * 1e3:.2f} ms, max "
        f"{max(step_s) * 1e3:.2f} ms; device memory {weights_gb:.3f} GB "
        f"of weights, serving peak {peak:.3f} GB ({smi})")
    log(f"[families] {arch} one decode step under torch.profiler: wall "
        f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms "
        f"= {100 * prof['busy_share']:.1f} %, {prof['launches']} kernel "
        f"launches")
    for key, count, ms in prof["top_device"][:8]:
        log(f"[families]   device {ms:9.3f} ms  x{count:<6} {key[:80]}")
    log(f"[families] {arch} req0 tokens: {tokens[0].tolist()}")
    out = {"n_layers": cfg.n_layers, "n_params": n_params,
           "n_kv_layers": n_kv, "launches": launches, "entries": entries,
           "generate_s": secs, "tokens_per_s": BATCH * NEW / secs,
           "prefill_ms": prefill_s * 1e3,
           "step_ms": [s * 1e3 for s in step_s],
           "step_median_ms": float(np.median(step_s)) * 1e3,
           "step_max_ms": max(step_s) * 1e3, "weights_gb": weights_gb,
           "peak_mem_gb": peak,
           "init_s": init_s, "profile": prof, "max_abs_err": 0.0}

    if cfg.n_experts:
        # the first MoE layer's router stream in a prefill (one group of
        # BATCH x PROMPT tokens): the CUDA dispatch against ``ref``
        streams = []
        arbiter = M.arbiter_positions

        def record(top_e, n_experts):
            streams.append(top_e)
            return arbiter(top_e, n_experts)
        M.arbiter_positions = record
        try:
            with torch.inference_mode():
                T.prefill(cfg, rc, params, toks)
        finally:
            M.arbiter_positions = arbiter
        top_e = streams[0]
        g, s_len, k = top_e.shape
        req = top_e.permute(0, 2, 1).reshape(g, k * s_len)
        cap = M.capacity(cfg, s_len)
        want_pos, want_kept = registry.get("moe_dispatch").ref(
            None, req, cfg.n_experts, capacity=cap)
        D.DISPATCH.launches = 0
        pos_k, kept_k = D.moe_dispatch_positions(req[0], cfg.n_experts, cap)
        torch.cuda.synchronize()
        n_launch = D.DISPATCH.launches
        same = (torch.equal(pos_k, want_pos[0])
                and torch.equal(kept_k, want_kept[0]))
        err = (pos_k.long() - want_pos[0].long()).abs().max().item()
        log(f"[families] {arch} first MoE layer's router stream (prefill, "
            f"{g} group of {s_len} tokens x top-{k} = {k * s_len} requests "
            f"over {cfg.n_experts} experts, capacity {cap}, "
            f"{int((~want_kept[0]).sum())} dropped): moe_dispatch_positions "
            f"({n_launch} launch) against the registry's ref: positions and "
            f"kept equal {same}, max |diff| {err}")
        if g != 1 or not same or n_launch != 1:
            raise AssertionError(f"[families] {arch}: the dispatch kernel "
                                 f"disagrees with the router's ref")
        out["router_dispatch"] = {"requests": k * s_len, "capacity": cap,
                                  "launches": n_launch, "max_abs_err": err}
    if check is not None:
        out["check"] = check(cfg, params)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _fp32_matmuls():
    """float32 matmuls in float32 inside the block (TF32 off)."""
    import torch
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _falcon_scan_check(cfg, params) -> dict:
    """Layer 0 of falcon-mamba at full width (the point's weights) in
    float32 on the card: ``mamba_prefill`` over PROMPT tokens (one chunk,
    and chunks of 16) against PROMPT ``mamba_decode`` steps, at the
    reference test's tolerances (y and h rtol 2e-4 / atol 2e-5, conv rtol
    1e-5 / atol 1e-6)."""
    import torch

    from repro_torch.models import ssm as SS
    from repro_torch.models import transformer as T

    p = T.superblock_params(params, 0, 0)["mixer"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = 0.1 * torch.randn((BATCH, PROMPT, cfg.d_model), generator=gen,
                          device="cuda")
    worst = {}
    with _fp32_matmuls(), torch.inference_mode():
        cache = {"h": torch.zeros((BATCH, cfg.d_inner, cfg.ssm_state),
                                  device="cuda"),
                 "conv": torch.zeros((BATCH, cfg.ssm_conv - 1, cfg.d_inner),
                                     device="cuda")}
        ys = []
        for t in range(PROMPT):
            y, cache = SS.mamba_decode(cfg, p, x[:, t:t + 1], cache)
            ys.append(y)
        y_seq = torch.cat(ys, dim=1)
        for chunk in (256, 16):
            y, c = SS.mamba_prefill(cfg, p, x, chunk=chunk)
            for name, a, b, rtol, atol in (
                    ("y", y, y_seq, 2e-4, 2e-5),
                    ("h", c["h"], cache["h"], 2e-4, 2e-5),
                    ("conv", c["conv"], cache["conv"], 1e-5, 1e-6)):
                worst[f"{name}_chunk{min(chunk, PROMPT)}"] = {
                    "max_abs": (a - b).abs().max().item(),
                    "scale": b.abs().max().item()}
                if not torch.allclose(a, b, rtol=rtol, atol=atol):
                    raise AssertionError(
                        f"[families] falcon layer 0 {name} (chunk {chunk}) "
                        f"off the sequential decode: max |diff| "
                        f"{(a - b).abs().max().item():.3g}")
    log(f"[families] falcon-mamba-7b layer 0 at full width, float32 on the "
        f"card: mamba_prefill over {PROMPT} tokens (one chunk; chunks of "
        f"16) against {PROMPT} mamba_decode steps: " + ", ".join(
            f"{k} max |diff| {v['max_abs']:.3g} of {v['scale']:.3g}"
            for k, v in worst.items()) + " (y, h: rtol 2e-4 atol 2e-5; "
        "conv: rtol 1e-5 atol 1e-6)")
    return worst


def _family_smokes() -> dict:
    """The smoke configs of the four families in float32, paged, on the
    card against the host on the same weights (made on the host from seed
    0): greedy tokens equal, the prefill's and every decode step's logits
    within FAMILY_LOGIT_TOL of the largest logit's magnitude."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import init_tree, model_specs
    from repro_torch.models.params import tree_map
    from repro_torch.serving.engine import ServeEngine

    rc = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
    out = {}
    for arch in FAMILY_SMOKES:
        cfg = get_smoke_config(arch)
        host = init_tree(model_specs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
        prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                    (2, 16))
        runs = {}
        for device, params in (("cpu", host), ("cuda", tree_map(
                lambda t: t.to("cuda"), host))):
            eng = ServeEngine(cfg, rc, params, max_batch=2, max_seq=24,
                              page_len=8, device=device)
            logits, sample = [], eng._sample

            def keep(lg, *args, _sample=sample, _logits=logits):
                _logits.append(lg[..., :cfg.vocab_size].float().cpu())
                return _sample(lg, *args)
            eng._sample = keep
            runs[device] = (eng.generate(prompts, max_new_tokens=8).tokens,
                            logits)
        (t_cpu, l_cpu), (t_gpu, l_gpu) = runs["cpu"], runs["cuda"]
        scale = max(x.abs().max().item() for x in l_cpu)
        err = max((a - b).abs().max().item() for a, b in zip(l_gpu, l_cpu))
        log(f"[families] {cfg.name} float32, card against host: tokens "
            f"equal {np.array_equal(t_cpu, t_gpu)}; {len(l_cpu)} logits "
            f"(prefill + decode steps) max |diff| {err:.3g} = "
            f"{err / scale:.3g} of max |logit| {scale:.4g} (tolerance "
            f"{FAMILY_LOGIT_TOL})")
        if not np.array_equal(t_cpu, t_gpu) or err > FAMILY_LOGIT_TOL * scale:
            raise AssertionError(f"[families] {cfg.name}: the card's "
                                 f"float32 serving differs from the host's")
        out[arch] = {"max_abs_err": err, "scale": scale,
                     "steps": len(l_cpu)}
    return out


def phase_families(smi: str) -> dict:
    """Serving the MoE, SSM and hybrid families on the card (slice 5a),
    after every earlier model is freed: (a) jamba-v0.1-52b (one superblock
    of 8 layers) and falcon-mamba-7b (64 layers) at full width, each
    point's time, memory and a profiled decode step; (b) jamba's paged
    generation through the row kernels equal to the plain one, (c)
    falcon's launching none; (d) falcon's layer 0 scan against its
    recurrence in float32; (e) jamba's router stream through the dispatch
    kernel; (f) the four smoke configs, card against host, in float32."""
    import torch

    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated() / 1e9
    log(f"[families] device memory held before the phase: {held:.3f} GB")
    points = {arch: _family_point(
        arch, n, smi, _falcon_scan_check if arch == "falcon-mamba-7b"
        else None) for arch, n in FAMILY_POINTS}
    with _fp32_matmuls():
        smokes = _family_smokes()
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"[families] phase wall {wall:.2f} s; device memory held after: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB ({smi})")
    jamba = points["jamba-v0.1-52b"]
    return {"points": points, "smokes": smokes,
            "wall_s": wall,
            "launches": jamba["launches"], "entries": jamba["entries"],
            "router_dispatch": jamba["router_dispatch"],
            "max_abs_err": 0.0}


#: the full-width training points: (arch, layers kept, remat), each the
#: train CLI's traffic (global batch 16 x seq 64, synthetic data), random
#: f32 weights from seed 0, bf16 compute, f32 AdamW state.  phi3.5-moe
#: keeps 2 of its 32 layers (2.865 G parameters, 45.8 GB of training
#: state); falcon-mamba-7b 24 of 64 (3.060 G, 49.0 GB), under remat "full"
#: because its scan keeps about 7.6 GB a layer for the backward;
#: musicgen-medium all 48 (1.818 G, 29.1 GB), its 256 audio frames ahead of
#: the 64 text tokens
TRAIN_POINTS = (("phi3.5-moe-42b-a6.6b", 2, "none"),
                ("falcon-mamba-7b", 24, "full"),
                ("musicgen-medium", 48, "none"))
#: the non-dense smoke configs, one float32 train step card against host
TRAIN_SMOKES = ("jamba-v0.1-52b", "falcon-mamba-7b", "mixtral-8x22b",
                "phi3.5-moe-42b-a6.6b", "musicgen-medium",
                "phi-3-vision-4.2b")
#: float32 tolerance of (c): each gradient of falcon's layer 0 through
#: the chunked scan against the same through the recurrent steps, within
#: this share of the gradient's largest magnitude (the two sum the same
#: terms in other orders: the doubling scan pairs the products as a
#: tree, the steps in a chain)
SCAN_GRAD_TOL = 1e-4


def _live_cuda_tensors(n: int = 6) -> list:
    """The ``n`` largest CUDA tensors that Python's gc tracks, as (bytes
    of their storage, shape, dtype): what holds device memory after a
    point is freed."""
    import torch
    found = [(o.untyped_storage().nbytes(), tuple(o.shape), str(o.dtype))
             for o in gc.get_objects()
             if isinstance(o, torch.Tensor) and o.is_cuda]
    return sorted(found, reverse=True)[:n]


def _train_point(arch: str, n_layers: int, remat: str, smi: str,
                 keep=None) -> tuple:
    """One full-width point through the train CLI (``main``), 4 steps,
    the last under ``torch.profiler``, with ``get_config`` cut to
    ``n_layers`` and every kernel's launch count from 0.  ``keep(cfg,
    state)``, if given, runs on the trained state before it is freed.
    Returns the point's record and keep's result."""
    import contextlib
    import dataclasses
    import io

    import torch

    from repro_torch.launch import train as train_cli
    from repro_torch.models import count_params, model_specs

    full = train_cli.get_config

    def cut(name):
        return dataclasses.replace(full(name), n_layers=n_layers)
    cfg = cut(arch)
    counts = cfg.param_counts()
    n_params = count_params(model_specs(cfg))
    state_gb = 4 * 4 * n_params / 1e9
    log(f"[train_families] {arch} at full width, {n_layers} of "
        f"{full(arch).n_layers} layers, remat {remat!r}: {n_params:,} "
        f"parameters ({counts['active']:,} active a token), f32 parameters, "
        f"gradients and two moments {state_gb:.2f} GB; device memory held "
        f"before: {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    text = io.StringIO()
    entries = _entries()
    for e in entries.values():
        e.launches = 0
    train_cli.get_config = cut
    try:
        def cli():
            with contextlib.redirect_stdout(text):
                return train_cli.main(["--arch", arch, "--steps", "4",
                                       "--remat", remat])
        out, steps, peak = _run_steps("train_families", arch, cli,
                                      counts["active"], smi, profile_at=3)
    finally:
        train_cli.get_config = full
    # the path's launches, read before a check launches a kernel
    launches = {name: e.launches for name, e in entries.items()}
    kept = keep(cfg, out["state"]) if keep is not None else None
    del out
    gc.collect()
    torch.cuda.empty_cache()
    timed = steps[1:3]
    record = {"n_layers": n_layers, "remat": remat, "n_params": n_params,
              "n_active": counts["active"], "state_gb": state_gb,
              "steps": steps, "peak_gb": peak, "path_launches": launches,
              "step_s": [s["s"] for s in timed],
              "tokens_per_s": [s["tokens"] / s["s"] for s in timed],
              "model_flops_share": [s["model_tflops"] / BF16_PEAK_TFLOPS
                                    for s in timed],
              "profile": steps[3]["profile"],
              "final_printed": text.getvalue().startswith("final: {")}
    return record, kept


def _router_stream_check(cfg, state) -> dict:
    """(d): phi3.5-moe's first layer's router stream in a training
    forward of the point's trained weights (the CLI's next batch, one
    group of 1024 tokens) through the CUDA dispatch kernel against the
    registry's ``ref``, bit-equal."""
    import torch

    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import registry
    from repro_torch.kernels.moe_dispatch import ops as D
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=64, global_batch=16,
                     seed=0)
    streams, arbiter = [], M.arbiter_positions

    def record(top_e, n_experts):
        streams.append(top_e)
        return arbiter(top_e, n_experts)
    M.arbiter_positions = record
    try:
        with torch.no_grad():
            T.loss_fn(cfg, RunConfig(remat="none", attn_impl="dense"),
                      state.params, ds.batch(4, device="cuda"))
    finally:
        M.arbiter_positions = arbiter
    top_e = streams[0]
    g, s_len, k = top_e.shape
    req = top_e.permute(0, 2, 1).reshape(g, k * s_len)
    cap = M.capacity(cfg, s_len)
    want_pos, want_kept = registry.get("moe_dispatch").ref(
        None, req, cfg.n_experts, capacity=cap)
    D.DISPATCH.launches = 0
    pos_k, kept_k = D.moe_dispatch_positions(req[0], cfg.n_experts, cap)
    torch.cuda.synchronize()
    n_launch = D.DISPATCH.launches
    same = (torch.equal(pos_k, want_pos[0])
            and torch.equal(kept_k, want_kept[0]))
    err = (pos_k.long() - want_pos[0].long()).abs().max().item()
    log(f"[train_families] (d) {cfg.name} first MoE layer's router stream "
        f"in a training forward ({g} group of {s_len} tokens x top-{k} = "
        f"{k * s_len} requests over {cfg.n_experts} experts, capacity {cap}, "
        f"{int((~want_kept[0]).sum())} dropped): moe_dispatch_positions "
        f"({n_launch} launch) against the registry's ref: positions and "
        f"kept equal {same}, max |diff| {err}")
    if g != 1 or not same or n_launch != 1:
        raise AssertionError("[train_families] (d) the dispatch kernel "
                             "disagrees with the training router's ref")
    return {"requests": k * s_len, "capacity": cap, "launches": n_launch,
            "dropped": int((~want_kept[0]).sum()), "max_abs_err": err}


def _falcon_scan_grad_check(cfg, state) -> dict:
    """(c): falcon's layer 0 (the point's trained weights) at full width
    in float32 on the card over PROMPT tokens: the gradient of sum(y * w)
    with respect to ``in_proj`` and ``A_log`` through ``mamba_prefill``
    (one chunk) against the same through PROMPT ``mamba_decode`` steps,
    each within SCAN_GRAD_TOL of its largest magnitude; and the bytes one
    layer's forward keeps for the backward at the CLI's 16 x 64 (every
    saved tensor's storage once)."""
    import torch

    from repro_torch.models import ssm as SS
    from repro_torch.models import transformer as T

    p = {k: v.detach().clone() for k, v in
         T.superblock_params(state.params, 0, 0)["mixer"].items()}
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = 0.1 * torch.randn((BATCH, PROMPT, cfg.d_model), generator=gen,
                          device="cuda")
    w = torch.randn((BATCH, PROMPT, cfg.d_model), generator=gen,
                    device="cuda")
    names = ("in_proj", "A_log")

    def grads(run):
        q = {k: (v.requires_grad_(True) if k in names else v)
             for k, v in ((k, v.clone()) for k, v in p.items())}
        y = run(q)
        return torch.autograd.grad((y * w).sum(), [q[k] for k in names])

    def recurrent(q):
        cache = {"h": torch.zeros((BATCH, cfg.d_inner, cfg.ssm_state),
                                  device="cuda"),
                 "conv": torch.zeros((BATCH, cfg.ssm_conv - 1, cfg.d_inner),
                                     device="cuda")}
        ys = []
        for t in range(PROMPT):
            y, cache = SS.mamba_decode(cfg, q, x[:, t:t + 1], cache)
            ys.append(y)
        return torch.cat(ys, dim=1)
    with _fp32_matmuls():
        scan = grads(lambda q: SS.mamba_prefill(cfg, q, x)[0])
        steps = grads(recurrent)
    out = {}
    for name, a, b in zip(names, scan, steps):
        diff, scale = (a - b).abs().max().item(), b.abs().max().item()
        out[name] = {"max_abs": diff, "scale": scale}
        if not diff <= SCAN_GRAD_TOL * scale or not scale > 0:
            raise AssertionError(f"[train_families] (c) d/d {name} through "
                                 f"the scan is off the recurrence: max "
                                 f"|diff| {diff:.3g} of {scale:.3g}")

    # the bytes a layer keeps for its backward, at the CLI's batch, bf16
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = max(seen.get(st.data_ptr(), 0), st.nbytes())
        # a detached alias: the graph holding ``t`` itself (an op's saved
        # output) would be a reference cycle gc cannot free
        return t.detach()
    xb = torch.randn((16, 64, cfg.d_model), generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    q = {k: v.requires_grad_(True) for k, v in p.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y, _ = SS.mamba_prefill(cfg, q, xb)
    saved_gb = sum(seen.values()) / 1e9
    del y, q, seen
    log(f"[train_families] (c) falcon-mamba-7b layer 0 at full width, "
        f"float32 on the card, {BATCH} x {PROMPT} tokens: d sum(y*w) / d "
        + ", ".join(f"{k} max |diff| {v['max_abs']:.3g} of {v['scale']:.3g}"
                    for k, v in out.items())
        + f" through the scan against {PROMPT} recurrent steps (tolerance "
        f"{SCAN_GRAD_TOL} of the largest); one Mamba mixer's forward at 16 x "
        f"64 keeps {saved_gb:.3f} GB for its backward (bf16 compute)")
    out["saved_gb_a_layer_16x64"] = saved_gb
    return out


def _train_smokes() -> dict:
    """(b): each non-dense smoke config's float32 train step on the card
    against the same step on the host (TF32 off): loss rtol 1e-5, aux
    within 1e-6, grad_norm rtol 1e-4, the updated parameters and moments
    within rtol 1e-4 / atol 1e-6."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM

    rc = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32",
                   warmup_steps=2, learning_rate=3e-3)
    out = {}
    with _fp32_matmuls():
        for arch in TRAIN_SMOKES:
            cfg = get_smoke_config(arch)
            ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=32,
                             global_batch=4, seed=3, branching=2,
                             frontend_tokens=cfg.n_frontend_tokens
                             if cfg.frontend else 0, d_model=cfg.d_model)
            met_c, met_h, cmp = _card_vs_host_step(cfg, rc, ds)
            log(f"[train_families] (b) {cfg.name} float32 step, card vs "
                f"host: loss {float(met_c['loss']):.9g} vs "
                f"{float(met_h['loss']):.9g} (rel {cmp['loss_rel']:.3g}), "
                f"aux {float(met_c['aux']):.9g} vs {float(met_h['aux']):.9g}"
                f", grad_norm rel {cmp['grad_norm_rel']:.3g}; params, m, "
                f"v: max(|diff| - 1e-4 |host|) {cmp['excess']:.3g}")
            if not (cmp["loss_rel"] <= 1e-5 and cmp["aux_abs"] <= 1e-6
                    and cmp["grad_norm_rel"] <= 1e-4
                    and cmp["excess"] <= 1e-6):
                raise AssertionError(f"[train_families] (b) {cfg.name}: the "
                                     f"card's step differs from the host's")
            out[arch] = cmp
    return out


def phase_train_families(smi: str) -> dict:
    """Training and scoring the MoE, SSM, hybrid and frontend families on
    the card (slice 5b), after every earlier model is freed: (a) the train
    CLI at full width of phi3.5-moe (2 layers), falcon-mamba-7b (24
    layers, remat "full") and musicgen-medium (48 layers, 256 audio
    frames ahead of 64 tokens), 4 steps each, the first apart and the
    last profiled: finite losses and gradient norms above 0; (b) the six
    non-dense smoke configs' float32 step, card against host; (c)
    falcon's layer 0, the scan's gradient against the recurrence's; (d)
    phi3.5-moe's training router stream through the dispatch kernel.  No
    kernel of the seven is on the path (its launches are counted)."""
    import torch

    t_phase = time.perf_counter()
    log(f"[train_families] device memory held before the phase: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB; TF32 matmuls "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    keeps = {"phi3.5-moe-42b-a6.6b": _router_stream_check,
             "falcon-mamba-7b": _falcon_scan_grad_check}
    points, checks = {}, {}
    for arch, n_layers, remat in TRAIN_POINTS:
        held = torch.cuda.memory_allocated()
        rec, kept = _train_point(arch, n_layers, remat, smi, keeps.get(arch))
        left = torch.cuda.memory_allocated() - held
        rec["left_allocated_gb"] = left / 1e9
        if left > 1e8:
            log(f"[train_families] {arch} left {left / 1e9:.3f} GB "
                f"allocated; the largest CUDA tensors gc can see: "
                f"{_live_cuda_tensors()}")
        if arch in keeps:
            rec["check"] = kept
        points[arch] = rec
        steps = rec["steps"]
        checks[f"(a) {arch}: 4 steps, finite loss and grad_norm > 0"] = (
            len(steps) == 4 and all(
                np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                and s["grad_norm"] > 0 for s in steps))
        checks[f"(a) {arch}: aux > 0 exactly with experts"] = all(
            np.isfinite(s["aux"]) and (s["aux"] > 0) == (arch.startswith(
                "phi3.5")) for s in steps)
        checks[f"(a) {arch}: final printed"] = rec["final_printed"]
        checks[f"(a) {arch}: no kernel on the path"] = not any(
            rec["path_launches"].values())
        log(f"[train_families] {arch}: steps 1-2 "
            + ", ".join(f"{t:.4f} s" for t in rec["step_s"])
            + "; tokens/s " + ", ".join(f"{t:.1f}" for t in
                                        rec["tokens_per_s"])
            + "; 6·N_active·positions " + ", ".join(
                f"{100 * m:.2f} %" for m in rec["model_flops_share"])
            + f" of the bf16 peak; peak {rec['peak_gb']:.3f} GB; profiled "
            f"step busy {100 * rec['profile']['busy_share']:.1f} % ({smi})")
    smokes = _train_smokes()
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[train_families] phase wall {wall:.2f} s; device memory held "
        f"after: {torch.cuda.memory_allocated() / 1e9:.3f} GB ({smi}); "
        f"checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"train_families checks failed: {checks}")
    router = points["phi3.5-moe-42b-a6.6b"]["check"]
    return {"points": points, "smokes": smokes, "checks": checks,
            "wall_s": wall, "router_dispatch": router,
            "router_launches": router["launches"]}


#: the mesh phase: the train CLI's shapes (global batch x seq), steps
MESH_TRAIN = (16, 64, 3)
#: moe_a2a at full width of phi3.5-moe: (batch, seq) of one data rank's
#: rows, 1024 tokens (one gshard group, so both dispatches cap alike)
MESH_MOE_ROWS = (2, 512)
#: the one-stage pipeline: microbatches, rows a microbatch, width
MESH_PIPE = (8, 16, 4096)
#: (f): inference through the mesh path: (arch, layers; None: all of
#: them), then batch x prompt and the greedy decode steps
MESH_INFER_MODELS = (("llama3.2-1b", None), ("jamba-v0.1-52b", 8))
MESH_INFER = (4, 512, 8)


def _grown(cfg, cache: dict, buffer: int) -> dict:
    """A one-rank prefill cache with each attention leaf padded to the
    ``buffer``-position decode cache (``cache_specs``)."""
    import torch.nn.functional as F

    from repro_torch.models import transformer as T
    want = T.cache_specs(cfg, 1, buffer)["blocks"]
    return {"blocks": {key: {name: F.pad(t, (0, 0, 0, 0, 0, want[key][
        name].shape[2] - t.shape[2])) if name in ("k", "v") else t
        for name, t in block.items()}
        for key, block in cache["blocks"].items()}}


def _mesh_inference(mesh, smi: str) -> tuple:
    """(f) ``prefill`` and greedy ``decode_step``s (``MESH_INFER``) through
    the mesh path (``ax`` on the one-rank mesh) against the one-device
    path (``NO_AXES``), at full width with the dry run's inference
    ``RunConfig`` (bf16 parameters and compute): llama3.2-1b whole, jamba
    cut to one superblock (attention, Mamba and MoE decode).  Four runs
    in turns, one device, mesh, mesh, one device, each from an emptied
    allocator cache with the earlier runs' outputs on the host: tokens
    and logits of every run bit-equal to the first's, and the peak device
    memory above the run's starting allocation of each mesh run equal to
    the second one-device run's (the first warms the libraries'
    workspaces).  Returns (checks, record)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _default_rc
    from repro_torch.launch.sharding import NO_AXES, make_axes
    from repro_torch.models import init_tree, model_specs
    from repro_torch.models import transformer as T

    rc = _default_rc("decode")
    batch, prompt, steps = MESH_INFER
    checks, record = {}, {}
    for arch, layers in MESH_INFER_MODELS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        tag = f"{arch}" + (f" cut to {layers} layers" if layers else "")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = init_tree(model_specs(cfg), gen, torch.bfloat16, "cuda")
        weights_gb = torch.cuda.memory_allocated() / 1e9
        toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                             generator=gen, device="cuda")
        ax = make_axes(mesh, rc).for_batch(batch)

        def run(on):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits, cache = T.prefill(cfg, rc, params, toks, ax=on)
                cache = _grown(cfg, cache, prompt + steps)
                outs, picked = [logits[:, -1]], []
                for i in range(steps + 1):
                    tok = outs[-1][:, :cfg.vocab_size].argmax(-1,
                                                              keepdim=True)
                    picked.append(tok)
                    if i == steps:
                        break
                    logits, cache = T.decode_step(
                        cfg, rc, params, tok, cache,
                        torch.tensor(prompt + i, device="cuda"), ax=on)
                    outs.append(logits[:, -1])
            torch.cuda.synchronize()
            out = {"s": time.perf_counter() - t0,
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "above_start": torch.cuda.max_memory_allocated() - base,
                   "tokens": torch.cat(picked, 1).cpu(),
                   "logits": torch.stack(outs).cpu()}
            del cache, logits, outs, picked
            return out

        runs = [(on, run(ax if on == "mesh" else NO_AXES))
                for on in ("one device", "mesh", "mesh", "one device")]
        first = runs[0][1]
        same = [torch.equal(r["tokens"], first["tokens"])
                and torch.equal(r["logits"], first["logits"])
                for _, r in runs]
        peaks = [r["peak_gb"] for _, r in runs]
        above = [r["above_start"] for _, r in runs]
        walls = [r["s"] for _, r in runs]
        log(f"[mesh] (f) {tag}, bf16 parameters ({weights_gb:.3f} GB): "
            f"prefill {batch} x {prompt} and {steps} greedy decode steps "
            f"in turns one device / mesh / mesh / one device: walls "
            f"{[round(w, 4) for w in walls]} s, peaks "
            f"{[round(p, 6) for p in peaks]} GB "
            f"(torch.cuda.max_memory_allocated), {above} B above each "
            f"run's start, tokens and logits "
            f"bit-equal to the first run's {same}; tokens "
            f"{first['tokens'][0].tolist()} ({smi})")
        checks[f"(f) {arch} mesh == one device, bit for bit"] = all(same)
        checks[f"(f) {arch} mesh peak == one device's"] = (
            above[1] == above[2] == above[3])
        checks[f"(f) {arch} finite logits"] = bool(
            torch.isfinite(first["logits"]).all())
        record[arch] = {"layers": cfg.n_layers, "weights_gb": weights_gb,
                        "walls_s": walls, "peaks_gb": peaks,
                        "peak_above_start_bytes": above, "bit_equal": same}
        del params, runs, first
        gc.collect()
        torch.cuda.empty_cache()
    return checks, record


def phase_mesh(smi: str) -> dict:
    """Meshes and collectives (slice 7b) on the card, on a one-rank NCCL
    group that the phase starts and ends: (a) ``make_current_mesh()`` is
    (1, 1); (b) the ``Trainer`` on that mesh trains llama3.2-1b at full
    width for 3 steps at the train CLI's shapes (16 x 64, dense
    attention), its losses equal to the one-device ``Trainer``'s on the
    same seed (every collective is the identity at one rank: the largest
    relative difference printed, rtol 1e-5 gates it), two runs of each
    in turns; (c) the smoke
    config trained on the mesh for 4 steps and checkpointed (full arrays;
    at full width a checkpoint is 15 GB of f32 state, more than the
    phase needs to write), restored by ``elastic_restore`` onto a fresh
    (1, 1) mesh at step 4, every leaf equal, and by the mesh ``Trainer``'s
    own resume (leaf by leaf, each rank's block), every leaf equal; (d) ``moe_a2a`` at full
    width of phi3.5-moe (d_model 4096, 16 experts, top-2, d_ff 6400, 5 GB
    of f32 expert weights) called directly (``a2a_applicable`` is false
    at tp = 1, as in the reference), ``y`` within 1e-4 of max |y| and
    ``aux`` within 1e-4 of ``moe_gshard``'s; (e) ``pipelined`` with one
    stage against the serial stage, within 1e-5; (f) inference through
    the mesh path (``_mesh_inference``): llama3.2-1b whole and jamba cut
    to one superblock, prefill and 8 greedy decode steps, bit-equal to
    one device's and at its peak memory.  Step times, peak device
    memory and the phase's wall time are printed beside the card's name
    and power limit; no kernel of the seven is launched."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import (compat_make_mesh, init_distributed,
                                         mesh_shape)
    from repro_torch.launch.sharding import make_axes, to_placements
    from repro_torch.models import count_params
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T
    from repro_torch.models.moe_a2a import a2a_applicable, moe_a2a
    from repro_torch.models.params import init_tree, leaves, tree_map
    from repro_torch.runtime.elastic import elastic_restore, make_current_mesh
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.pipeline import pipelined, stack_stage_params
    from repro_torch.train.step import init_train_state, state_placements
    from torch.distributed.tensor import DTensor, distribute_tensor

    t_phase = time.perf_counter()
    entries = _entries()
    for e in entries.values():
        e.launches = 0
    checks, record = {}, {"nvidia_smi": smi}
    if dist.is_initialized():
        raise AssertionError("a process group is already running")
    init_distributed("cuda")
    try:
        checks["NCCL one-rank group"] = (dist.get_backend() == "nccl"
                                         and dist.get_world_size() == 1)
        # (a)
        mesh = make_current_mesh()
        checks["(a) make_current_mesh() is (1, 1)"] = (
            mesh_shape(mesh) == {"data": 1, "model": 1}
            and mesh.device_type == "cuda")

        # (b) one device, then the mesh, same seed and data
        cfg = get_config("llama3.2-1b")
        n_params = count_params(T.model_specs(cfg))
        batch, seq, n_steps = MESH_TRAIN
        rc = RunConfig(remat="none", attn_impl="dense", learning_rate=1e-3,
                       warmup_steps=1)
        ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                         global_batch=batch, seed=0)
        # in turns, one device, mesh, mesh, one device; a run's result is
        # dropped before the next starts, so each peak is its own
        runs = {"one device": [], "mesh (1, 1)": []}
        for tag in ("one device", "mesh (1, 1)", "mesh (1, 1)",
                    "one device"):
            on = mesh if tag.startswith("mesh") else None
            steps, peak = _run_steps(
                "mesh", f"(b) {tag}", lambda: Trainer(
                    cfg, rc, TrainerConfig(total_steps=n_steps, log_every=1),
                    ds, mesh=on, device="cuda").run(), n_params, smi)[1:]
            runs[tag].append({"steps": steps, "peak_gb": peak})
            gc.collect()
            torch.cuda.empty_cache()
        losses = {k: [[s["loss"] for s in r["steps"]] for r in v]
                  for k, v in runs.items()}
        one = losses["one device"][0]
        loss_rel = max(abs(a - b) / abs(b) for run in
                       losses["mesh (1, 1)"] + losses["one device"][1:]
                       for a, b in zip(run, one))
        times = {k: [s["s"] for r in v for s in r["steps"][1:]]
                 for k, v in runs.items()}
        peaks = {k: [r["peak_gb"] for r in v] for k, v in runs.items()}
        ratio = float(np.median(times["mesh (1, 1)"]) /
                      np.median(times["one device"]))
        log(f"[mesh] (b) llama3.2-1b {batch} x {seq}, losses on the mesh "
            f"{losses['mesh (1, 1)']} vs one device "
            f"{losses['one device']}: largest relative difference "
            f"{loss_rel:.3g}; steps 1-{n_steps - 1} of two runs each "
            f"{times['mesh (1, 1)']} s vs {times['one device']} s, median "
            f"ratio {ratio:.4f}; peaks {peaks['mesh (1, 1)']} vs "
            f"{peaks['one device']} GB ({smi})")
        checks["(b) 3 finite steps each"] = all(
            len(r["steps"]) == n_steps and np.isfinite(
                [s["loss"] for s in r["steps"]]).all()
            for v in runs.values() for r in v)
        checks["(b) mesh losses == one device's (rtol 1e-5)"] = (
            loss_rel <= 1e-5)
        record["train"] = {**runs, "loss_rel": loss_rel,
                           "median_step_ratio": ratio}

        # (c) checkpoint on the mesh, elastic restore onto a fresh (1, 1)
        smoke = get_smoke_config("llama3.2-1b")
        rc_s = RunConfig(remat="none", attn_impl="dense",
                         learning_rate=3e-3, warmup_steps=2)
        ds_s = SyntheticLM(vocab_size=smoke.vocab_size, seq_len=32,
                           global_batch=8, seed=1, branching=2)
        (ROOT / "build").mkdir(exist_ok=True)
        ck = tempfile.mkdtemp(prefix="mesh_", dir=ROOT / "build")
        try:
            out = Trainer(smoke, rc_s, TrainerConfig(
                total_steps=4, ckpt_dir=ck, ckpt_every=2, log_every=1),
                ds_s, mesh=mesh, device="cuda").run()
            # the mesh Trainer's own resume: each full array read on the
            # host, this rank's block kept; at step 4 of 4 nothing trains
            resumed = Trainer(smoke, rc_s, TrainerConfig(
                total_steps=4, ckpt_dir=ck, ckpt_every=2, log_every=1),
                ds_s, mesh=mesh, device="cuda").run()["state"]
            fresh_mesh = make_current_mesh()
            specs = state_placements(smoke, rc_s, make_axes(fresh_mesh,
                                                            rc_s))
            template = tree_map(lambda t, spec: distribute_tensor(
                t, fresh_mesh, to_placements(spec, fresh_mesh)),
                init_train_state(smoke, rc_s, torch.Generator(
                    device="cuda").manual_seed(9), "cuda"), specs)
            state, step = elastic_restore(ck, template)
        finally:
            shutil.rmtree(ck, ignore_errors=True)
        same = leaves(tree_map(
            lambda t, u: torch.equal(t.full_tensor(), u),
            {"p": state.params, "m": state.opt.m, "v": state.opt.v},
            {"p": out["state"].params, "m": out["state"].opt.m,
             "v": out["state"].opt.v}))
        checks["(c) restored at step 4 onto a fresh (1, 1) mesh"] = (
            step == 4 and all(isinstance(t, DTensor)
                              for t in leaves(state.params)))
        checks["(c) every restored leaf == the trained one"] = all(same)
        same_resumed = leaves(tree_map(
            torch.equal, {"p": resumed.params, "m": resumed.opt.m,
                          "v": resumed.opt.v},
            {"p": out["state"].params, "m": out["state"].opt.m,
             "v": out["state"].opt.v}))
        checks["(c) the mesh Trainer resumes at step 4, every leaf =="] = (
            int(resumed.step) == 4 and all(same_resumed))
        record["elastic"] = {"step": step, "leaves": len(same),
                             "trainer_resumed_step": int(resumed.step)}
        del out, state, template, resumed

        # (d) moe_a2a at full width of phi3.5-moe against moe_gshard
        moe_cfg = get_config("phi3.5-moe-42b-a6.6b")
        ax = make_axes(mesh, None)
        gen = torch.Generator(device="cuda").manual_seed(0)
        p = init_tree(M.moe_specs(moe_cfg), gen, torch.float32, "cuda")
        x = torch.randn(*MESH_MOE_ROWS, moe_cfg.d_model, generator=gen,
                        device="cuda")
        def timed(fn):
            """fn's result and the host time of a second, warm call."""
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0
        with torch.no_grad():
            (y_ref, aux_ref), gshard_s = timed(
                lambda: M.moe_gshard(moe_cfg, p, x))
            (y, aux), a2a_s = timed(lambda: moe_a2a(moe_cfg, p, x, ax))
        y_err = (y - y_ref).abs().max().item()
        y_max = y_ref.abs().max().item()
        aux_err = abs(aux.item() - aux_ref.item())
        weights_gb = sum(t.numel() * 4 for t in p.values()) / 1e9
        log(f"[mesh] (d) moe_a2a at full width of phi3.5-moe "
            f"({MESH_MOE_ROWS[0]} x {MESH_MOE_ROWS[1]} tokens, "
            f"{weights_gb:.3f} GB of f32 weights): max |y - gshard| "
            f"{y_err:.6g} of max |y| {y_max:.6g} (tolerance 1e-4 of it), "
            f"aux {aux.item():.9g} vs {aux_ref.item():.9g}; a warm call "
            f"{a2a_s * 1e3:.2f} ms, gshard's {gshard_s * 1e3:.2f} ms "
            f"({smi})")
        checks["(d) a2a_applicable false at tp = 1"] = not a2a_applicable(
            moe_cfg, ax, MESH_MOE_ROWS[1])
        checks["(d) moe_a2a y == gshard (1e-4 of max |y|)"] = (
            y_err <= 1e-4 * y_max)
        checks["(d) moe_a2a aux == gshard (1e-4)"] = aux_err <= 1e-4
        record["moe_a2a"] = {"y_err": y_err, "y_max": y_max,
                             "aux_err": aux_err, "weights_gb": weights_gb,
                             "call_ms": a2a_s * 1e3,
                             "gshard_call_ms": gshard_s * 1e3}
        del p, x, y, y_ref

        # (e) a one-stage pipeline: the ring is a local copy
        n_micro, rows, width = MESH_PIPE
        stage_mesh = compat_make_mesh((1,), ("stage",))
        w = torch.randn(width, width, generator=gen, device="cuda") * \
            width ** -0.5
        b = 0.1 * torch.randn(width, generator=gen, device="cuda")
        xs = torch.randn(n_micro, rows, width, generator=gen, device="cuda")

        def stage_fn(q, h):
            return torch.tanh(h @ q["w"] + q["b"])
        got = pipelined(stage_fn, stage_mesh, "stage")(
            stack_stage_params([{"w": w, "b": b}]), xs)
        serial = torch.stack([stage_fn({"w": w, "b": b}, x) for x in xs])
        pipe_err = (got - serial).abs().max().item()
        log(f"[mesh] (e) one-stage pipeline, {n_micro} microbatches of "
            f"{rows} x {width}: max |ring - serial| {pipe_err:.3g} "
            f"(tolerance 1e-5)")
        checks["(e) one-stage pipeline == serial (1e-5)"] = pipe_err <= 1e-5
        record["pipeline_err"] = pipe_err
        del w, b, xs, got, serial
        gc.collect()
        torch.cuda.empty_cache()

        # (f) inference through the mesh path
        more, record["inference"] = _mesh_inference(mesh, smi)
        checks.update(more)
    finally:
        dist.destroy_process_group()
    launches = {name: e.launches for name, e in entries.items()}
    checks["no kernel launched"] = not any(launches.values())
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[mesh] phase wall {wall:.2f} s ({smi}); kernel launches "
        f"{launches}; checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"mesh checks failed: {checks}")
    return {**record, "checks": checks, "launches": launches,
            "wall_s": wall}


#: (a): llama3.2-1b whole at the train CLI's step (batch, seq), remat none
DRYRUN_STEP = (16, 64)
#: (a'): llama3.2-1b whole, a decode step at (batch, seq)
DRYRUN_DECODE = (4, 4096)
#: (b): the inference cells' per-device all-gather GiB as the dry run
#: counted them before inference ran on a mesh, in a modelled step (each
#: rank gathered its weights whole and its cache over every dimension but
#: the batch's)
DRYRUN_MODELLED_GIB = {("jamba-v0.1-52b", "decode_32k"): 106.161,
                       ("phi3.5-moe-42b-a6.6b", "prefill_32k"): 82.84}
#: (b): the reference's three end-to-end cells (tests/test_dryrun_e2e.py),
#: full configs on the 256-card stand-in
DRYRUN_CELLS = (("llama3.2-1b", "train_4k"), ("jamba-v0.1-52b", "decode_32k"),
                ("phi3.5-moe-42b-a6.6b", "prefill_32k"))
#: (b)'s trace subprocesses may take this long from the script's start
#: (phi3.5-moe's prefill at 32k tokens dispatches about 0.9 million ops)
DRYRUN_TIMEOUT_S = 700


def _card_inputs(tree, seed: int = 0):
    """Tensors on the card for a tree of ``ShapeStruct``s: each struct's
    local shape and dtype, floats drawn at 0.02 scale, integers in [0, 8)
    (valid token ids and positions)."""
    import torch

    from repro_torch.models.params import ShapeStruct
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(s):
        if isinstance(s, ShapeStruct):
            if s.dtype.is_floating_point:
                return (0.02 * torch.randn(s.local_shape, generator=gen,
                                           device="cuda")).to(s.dtype)
            return torch.randint(0, 8, s.local_shape, generator=gen,
                                 dtype=s.dtype, device="cuda")
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, tuple):
            return tuple(make(v) for v in s)
        return s
    return make(tree)


def _tensor_bytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts and (named) tuples."""
    if isinstance(tree, dict):
        return sum(map(_tensor_bytes, tree.values()))
    if isinstance(tree, tuple):
        return sum(map(_tensor_bytes, tree))
    return 0 if tree is None else tree.numel() * tree.element_size()


def start_dryrun_cells() -> dict:
    """(b)'s three cells, each through the dry-run CLI (``python -m
    repro_torch.launch.dryrun``, fake CUDA tensors, no allocation) in a
    subprocess of its own at a lower priority, all started together:
    {(arch, shape): (the process, its log, its start time)}."""
    import os
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = {}
    for arch, shape in DRYRUN_CELLS:
        log_path = ROOT / "build" / f"dryrun_{arch}__{shape}.log"
        with open(log_path, "w") as fh:
            procs[(arch, shape)] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--device", "cuda",
                 "--out", str(out_dir)], cwd=ROOT, env=env, stdout=fh,
                stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10)),
                log_path, time.perf_counter())
    return procs


def stop_dryrun_cells(procs: dict) -> None:
    """Kill any of (b)'s subprocesses still running."""
    for proc, _, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def phase_dryrun(smi: str, procs: dict) -> dict:
    """The compile-only accounting (slice 8) on the card.  (b), the
    reference's three end-to-end cells at full config on the 256-card
    stand-in, was started with the script (``start_dryrun_cells``) and
    has traced beside every earlier phase; this phase waits for what is
    left of it after (a).  (a) The
    yardstick held on the card: llama3.2-1b whole at the train CLI's step
    (16 x 64, remat none, f32 parameters, bf16 compute) dry-run by
    ``lower_cell`` on a (1, 1) stand-in, then the same step function run
    for real on the card under the same counting (``analyze``): the
    adjusted FLOPs and bytes equal the real step's exactly and the
    argument bytes equal those of the real ``TrainState`` and batch
    (hard checks); printed beside them, not gated: the predicted peak
    (arguments + temporaries) against ``torch.cuda.max_memory_allocated``
    and the three roofline terms and ``roofline_fraction`` against the
    measured step time (steps 1-3 uncounted), and the trace's host cost
    per op with the counter and without it.  (a') An inference cell
    held the same way: llama3.2-1b whole, a decode step at batch 4 and
    seq 4096 (bf16 parameters, the dry run's inference ``RunConfig``) on
    the (1, 1) stand-in, its FLOPs, bytes and argument bytes equal to a
    real ``decode_step`` on the card under ``analyze`` (hard checks).
    (b) For each cell: trace seconds and their cost per op, FLOPs per
    device, arguments, temporaries, collective GiB by kind, the dominant
    term and whether it fits 80 GB; an inference cell traces the mesh
    step the port runs (weights gathered a superblock at a time, the
    cache kept where the reference keeps it), printed beside the
    all-gather bytes of the modelled step it replaces.  (c) The
    reporting path over (b)'s artifacts: ``launch.summarize`` and the
    driver's ``table1`` and ``roofline`` sections.  No kernel of the
    seven is launched."""
    import dataclasses
    import io

    import torch

    from repro_torch.bench.run import main as run_main
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import summarize
    from repro_torch.launch.dryrun import (_default_rc, artifact_path,
                                           cell_inputs, lower_cell)
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import materialize
    from repro_torch.launch.hlo_analysis import CollectiveLog, analyze
    from repro_torch.launch.mesh import StandInMesh
    from repro_torch.launch.roofline import PEAK_FLOPS, adjusted, cell_roofline
    from repro_torch.launch.sharding import make_axes
    from repro_torch.train.step import init_train_state

    t_phase = time.perf_counter()
    entries = _entries()
    for e in entries.values():
        e.launches = 0
    checks, record = {}, {"nvidia_smi": smi}
    out_dir = ROOT / "build" / "dryrun"
    done_before = {cell: proc.poll() is not None
                   for cell, (proc, _, _) in procs.items()}
    # (a) the yardstick: the dry run against the real step on the card
    cfg = get_config("llama3.2-1b")
    batch_n, seq = DRYRUN_STEP
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=batch_n,
                                seq_len=seq)
    over = {"remat": "none", "attn_impl": "dense"}
    mesh = StandInMesh({"data": 1, "model": 1})
    t0 = time.perf_counter()
    art = lower_cell("llama3.2-1b", shape, False, over, verbose=False,
                     mesh=mesh, device="cuda")
    dry_s = time.perf_counter() - t0
    rc = _default_rc("train", over)
    step, structs = cell_inputs(cfg, rc, shape, make_axes(mesh, rc))
    # the trace's host cost per op, with the counter and without it
    per_op = {}
    with FakeTensorMode():
        fake = materialize(structs, "cuda")
        with CollectiveLog():
            step(*fake)                  # the fake kernels' first calls
        t0 = time.perf_counter()
        with CollectiveLog():
            step(*fake)
        per_op["bare"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_ops = analyze(step, *fake)[1]["ops"]
        per_op["counted"] = time.perf_counter() - t0
        del fake
    per_op = {k: 1e6 * v / n_ops for k, v in per_op.items()}
    state = init_train_state(cfg, rc, torch.Generator(
        device="cuda").manual_seed(0), "cuda")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                        global_batch=batch_n, seed=0).batch(
        0, device="cuda")
    real_args = _tensor_bytes((state, batch))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (state, _), real = analyze(step, state, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    times = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, 4):
        b = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                        global_batch=batch_n, seed=0).batch(
            i, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        loss = float(met["loss"])
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    mem = art["full"]["memory"]
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    r = cell_roofline(art)
    step_s = float(np.median(times))
    flops_eq = adjusted(art, "flops") == real["flops"]
    bytes_eq = adjusted(art, "bytes_accessed") == real["bytes_accessed"]
    args_eq = (mem["argument_bytes"] == real["memory"]["argument_bytes"]
               == real_args)
    log(f"[dryrun] (a) llama3.2-1b {batch_n} x {seq}, remat none, on a "
        f"(1, 1) stand-in: dry run {dry_s:.2f} s; FLOPs dry "
        f"{adjusted(art, 'flops'):.0f} vs the real step's "
        f"{real['flops']} (equal: {flops_eq}; matmuls "
        f"{real['matmul_flops']}), bytes "
        f"{adjusted(art, 'bytes_accessed'):.0f} vs "
        f"{real['bytes_accessed']} (equal: {bytes_eq}), argument "
        f"bytes {mem['argument_bytes']} vs {real['memory']['argument_bytes']}"
        f" counted, {real_args} of the TrainState and batch (equal: "
        f"{args_eq}); the counted step {counted_s:.3f} s; the fake "
        f"trace's host cost {per_op['counted']:.1f} us an op counted, "
        f"{per_op['bare']:.1f} us uncounted ({n_ops} ops)")
    log(f"[dryrun] (a) predicted peak (args + temp) {predicted / 1e9:.3f}"
        f" GB vs torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB over"
        f" steps 1-3 (PR 32: 24.142 GB); roofline terms compute "
        f"{r.compute_s * 1e3:.3f} ms, memory {r.memory_s * 1e3:.3f} ms "
        f"(lower bound {r.memory_lb_s * 1e3:.3f}), collective "
        f"{r.collective_s * 1e3:.3f} ms, dominant {r.dominant}, "
        f"roofline_fraction {r.roofline_fraction:.4f} (opt "
        f"{r.roofline_fraction_opt:.4f}); measured steps 1-3 "
        f"{[round(t, 4) for t in times]} s, median {step_s:.4f} s, so "
        f"the dominant bound is {100 * r.dominant_s / step_s:.2f} % of "
        f"the step and 6·N·D at the bf16 peak "
        f"{100 * r.model_flops / PEAK_FLOPS / step_s:.2f} % "
        f"(loss {loss:.5g}; {smi})")
    checks["(a) adjusted FLOPs == the real step's"] = flops_eq
    checks["(a) adjusted bytes == the real step's"] = bytes_eq
    checks["(a) argument bytes == TrainState + batch"] = args_eq
    checks["(a) finite loss"] = bool(np.isfinite(loss))
    record["yardstick"] = {
        "flops": real["flops"], "matmul_flops": real["matmul_flops"],
        "bytes_accessed": real["bytes_accessed"], "ops": real["ops"],
        "memory": mem, "real_memory": real["memory"],
        "predicted_peak_bytes": predicted, "max_memory_allocated": peak,
        "compute_s": r.compute_s, "memory_s": r.memory_s,
        "memory_lb_s": r.memory_lb_s, "collective_s": r.collective_s,
        "dominant": r.dominant, "roofline_fraction":
            r.roofline_fraction, "roofline_fraction_opt":
            r.roofline_fraction_opt, "step_s": times, "dry_s": dry_s,
        "counted_step_s": counted_s, "trace_us_per_op": per_op}
    del state, batch, b
    gc.collect()
    torch.cuda.empty_cache()

    # (a') an inference cell: a decode step, dry and on the card
    d_batch, d_seq = DRYRUN_DECODE
    d_shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=d_batch,
                                  seq_len=d_seq)
    t0 = time.perf_counter()
    d_art = lower_cell("llama3.2-1b", d_shape, False, verbose=False,
                       mesh=mesh, device="cuda")
    d_dry_s = time.perf_counter() - t0
    d_rc = _default_rc("decode")
    d_step, d_structs = cell_inputs(cfg, d_rc, d_shape, make_axes(mesh,
                                                                  d_rc))
    d_args = _card_inputs(d_structs)
    # no_grad, as the fake trace runs: inference_mode dispatches other ops
    with torch.no_grad():
        d_real = analyze(d_step, *d_args)[1]
    d_mem = d_art["full"]["memory"]
    d_eq = {"flops": adjusted(d_art, "flops") == d_real["flops"] > 0,
            "bytes": adjusted(d_art, "bytes_accessed") ==
            d_real["bytes_accessed"] > 0,
            "args": d_mem["argument_bytes"] ==
            d_real["memory"]["argument_bytes"] == _tensor_bytes(d_args)}
    log(f"[dryrun] (a') llama3.2-1b decode_32k cut to {d_batch} x {d_seq}"
        f" on a (1, 1) stand-in: dry run {d_dry_s:.2f} s; FLOPs dry "
        f"{adjusted(d_art, 'flops'):.0f} vs the real decode_step's "
        f"{d_real['flops']}, bytes {adjusted(d_art, 'bytes_accessed'):.0f}"
        f" vs {d_real['bytes_accessed']}, argument bytes "
        f"{d_mem['argument_bytes']} vs {d_real['memory']['argument_bytes']}"
        f" counted and {_tensor_bytes(d_args)} of the inputs: equal "
        f"{d_eq} ({smi})")
    for k, v in d_eq.items():
        checks[f"(a') decode {k} == the real step's"] = v
    record["decode_yardstick"] = {
        "flops": d_real["flops"], "bytes_accessed": d_real["bytes_accessed"],
        "memory": d_mem, "real_memory": d_real["memory"], "dry_s": d_dry_s}
    del d_args
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the three cells' subprocesses
    record["cells"] = {}
    t_wait = time.perf_counter()
    for (arch, shape_name), (proc, log_path, t0) in procs.items():
        rc_ = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (
            time.perf_counter() - t0)))
        wall = time.perf_counter() - t0
        if rc_:
            raise AssertionError(f"dry run of {arch} x {shape_name} "
                                 f"exited {rc_}: "
                                 f"{log_path.read_text()[-3000:]}")
        with open(artifact_path(str(out_dir), arch, shape_name,
                                "single")) as fh:
            cell = json.load(fh)
        rf = cell_roofline(cell)
        m = cell["full"]["memory"]
        ops = cell["full"]["ops"]
        coll = {k: v / 2 ** 30 for k, v in
                cell["full"]["collectives"].items()
                if k not in ("total", "count")}
        log(f"[dryrun] (b) {arch} x {shape_name} on the 256-card "
            f"stand-in: trace {cell['compile_s']:.1f} s ({ops} ops, "
            f"{1e6 * cell['compile_s'] / ops:.1f} us an op; the "
            f"subprocess {wall:.1f} s from the script's start, done "
            f"before this phase: {done_before[(arch, shape_name)]}); "
            f"FLOPs/device "
            f"{adjusted(cell, 'flops'):.4e}, args "
            f"{m['argument_bytes'] / 2 ** 30:.3f} GiB, temp "
            f"{m['temp_bytes'] / 2 ** 30:.3f} GiB, collectives "
            f"{ {k: round(v, 3) for k, v in coll.items()} } GiB; "
            f"dominant {rf.dominant} (compute {rf.compute_s:.4f} s, "
            f"memory {rf.memory_s:.4f} s, collective "
            f"{rf.collective_s:.4f} s), fits 80G: "
            f"{'Y' if rf.fits_hbm else 'N'}")
        was = DRYRUN_MODELLED_GIB.get((arch, shape_name))
        if was is not None:
            log(f"[dryrun] (b) {arch} x {shape_name} per device, the mesh "
                f"step: all-gather {coll.get('all-gather', 0):.3f} GiB "
                f"(the modelled step: {was} GiB), all-reduce "
                f"{coll.get('all-reduce', 0):.3f} GiB, arguments "
                f"{m['argument_bytes'] / 2 ** 30:.3f} GiB, temporaries "
                f"{m['temp_bytes'] / 2 ** 30:.3f} GiB, fits 80G: "
                f"{'Y' if rf.fits_hbm else 'N'}")
        checks[f"(b) {arch} x {shape_name} counted"] = (
            cell["chips"] == 256 and adjusted(cell, "flops") ==
            cell["full"]["flops"] > 0 and "modelled" not in cell)
        record["cells"][f"{arch}__{shape_name}"] = {
            "compile_s": cell["compile_s"], "lower_s": cell["lower_s"],
            "subprocess_s": wall, "ops": ops,
            "done_before_phase": done_before[(arch, shape_name)],
            "flops": cell["full"]["flops"], "memory": m,
            "collective_gib": coll, "dominant": rf.dominant,
            "compute_s": rf.compute_s, "memory_s": rf.memory_s,
            "collective_s": rf.collective_s, "fits_80g": rf.fits_hbm}
    record["wait_s"] = time.perf_counter() - t_wait

    # (c) the reporting path over (b)'s artifacts
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summarize.main(["--dir", str(out_dir.parent)])
        run_main(["table1", "roofline", "--device", "cuda"])
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[dryrun] (c) {line}")
    names = [f"roofline_{a}_{s}," for a, s in DRYRUN_CELLS]
    checks["(c) summarize lists the three cells"] = all(
        f"| {a} | {s} | single |" in text for a, s in DRYRUN_CELLS)
    checks["(c) the driver's table1 and roofline sections"] = (
        "# --- table1 ---" in text and "# --- roofline ---" in text
        and all(any(l.startswith(n) for l in text.splitlines())
                for n in names))
    launches = {name: e.launches for name, e in entries.items()}
    checks["no kernel launched"] = not any(launches.values())
    wall = time.perf_counter() - t_phase
    log(f"[dryrun] phase wall {wall:.2f} s ({smi}); kernel launches "
        f"{launches}; checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"dryrun checks failed: {checks}")
    return {**record, "checks": checks, "launches": launches,
            "wall_s": wall}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    # the dry run's (b) is host work on fake tensors: it runs beside every
    # other phase, and the dryrun phase reads what it wrote
    procs = start_dryrun_cells()
    try:
        return run_phases(procs)
    finally:
        stop_dryrun_cells(procs)


def run_phases(procs: dict) -> int:
    """Every phase in order, then the kernels' record and the last lines
    (``procs``: the dry run's (b), started by ``main``)."""
    import torch
    torch.manual_seed(0)
    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    record = {"build": phase_build()}
    record["kernels"] = phase_kernels()
    serve = phase_serve()
    engine = serve.pop("engine")
    record["serve"] = serve
    record["path_kernels"] = phase_path_kernels(engine)
    record["cost"] = phase_cost(engine)
    record["schedule"] = phase_schedule(engine, smi)
    healthy = record["schedule"].pop("outputs")
    record["faults"] = phase_faults(engine, healthy, smi)
    record["preempt"] = phase_preempt(engine, healthy,
                                      record["schedule"]["launches"], smi)
    record["tables"] = phase_tables()
    record["figures"] = phase_figures(smi)
    record["cost_bench"] = phase_cost_bench(smi)
    record["serving_bench"] = phase_serving_bench(smi)
    record["model_traffic"] = phase_model_traffic(smi)
    record["table_kernels"] = phase_table_kernels()
    record["table_sweep"] = phase_table_sweep()
    record["controllers"] = phase_controllers()
    record["dispatch"] = phase_dispatch()
    record["bench"] = phase_bench()
    record["times"] = phase_times(engine)
    record["row_times"] = phase_row_times()
    record["table_times"] = phase_table_times()
    record["controller_times"] = phase_controller_times()
    record["dispatch_times"] = phase_dispatch_times()
    # after every phase that reads kernels with ``_profiled_kernels``: in a
    # run where this phase's session came first, each later session lost
    # both of its opening markers
    record["quickstart"] = phase_quickstart(smi)
    record["profile"] = phase_profile(engine)
    record["analysis"] = phase_analysis(engine, serve, smi)
    # training needs the card's memory: the serving engine goes first
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    record["train"] = phase_train(smi)
    # the families' full-width points need the card's memory: the train
    # phase freed its models
    record["families"] = phase_families(smi)
    # the training points need the card's memory: the families phase
    # freed its models
    record["train_families"] = phase_train_families(smi)
    # a one-rank NCCL group of its own, started and ended in the phase
    record["mesh"] = phase_mesh(smi)
    # the compile-only accounting: the whole step counted against the card
    record["dryrun"] = phase_dryrun(smi, procs)
    record["nvidia_smi"] = smi
    record["torch"] = torch.__version__
    record["cuda"] = torch.version.cuda
    record["wall_s"] = time.perf_counter() - t_start

    replaces = {
        "banked_gather": "src/repro/kernels/banked_gather/kernel.py:74",
        "banked_scatter": "src/repro/kernels/banked_scatter/kernel.py:66",
        "banked_transpose":
            "src/repro/kernels/banked_transpose/kernel.py:31",
        "fft_stage": "src/repro/kernels/fft_stage/kernel.py:54",
        "conflict_popcount":
            "src/repro/kernels/conflict_popcount/kernel.py:43",
        "carry_arbiter": "src/repro/kernels/carry_arbiter/kernel.py:41",
        "moe_dispatch": "src/repro/kernels/moe_dispatch/kernel.py:59"}
    # the row kernels: launches of the serving paths (by entry too), times
    # where bytes rule (single table, 16384 lines), the serving shapes'
    # single and paired times beside them
    kernels = []
    for name in ("banked_gather", "banked_scatter"):
        t = record["row_times"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/banked_rows.cu",
            "replaces": replaces[name],
            "launches": serve["launches"][name] + sum(
                record[p]["launches"][name] for p in ROW_PATHS + (
                    "quickstart",)),
            # the paged oracle's check launches in the analysis phase are
            # held to the oracle, not the path's: out of the sum
            "launches_by_path": {
                "serve": serve["launches"][name],
                **{p: record[p]["launches"][name]
                   for p in ROW_PATHS + ("quickstart",)},
                "analysis_oracle_check":
                    record["analysis"]["oracle_launches"][name]},
            "entries": {"serve": serve["entries"][name],
                        **{p: record[p]["entries"][name]
                           for p in ROW_PATHS},
                        "analysis_oracle_check":
                            record["analysis"]["oracle_entries"][name]},
            "max_abs_err": max(record["kernels"]["max_abs_err"][name],
                               record["path_kernels"]["max_abs_err"][name],
                               record["schedule"]["max_abs_err"],
                               record["faults"]["max_abs_err"],
                               record["preempt"]["max_abs_err"],
                               record["row_times"]["max_abs_err"][name],
                               record["figures"]["max_abs_err"].get(name,
                                                                    0.0),
                               record["families"]["max_abs_err"],
                               record["analysis"]["max_abs_err"],
                               record["quickstart"]["max_abs_err"].get(
                                   name, 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "serving": {k: {f: record["times"][f"{name}_{k}"][f]
                            for f in ("ms", "device_ms", "plain_ms",
                                      "library_ms", "library_device_ms",
                                      "bound_ms")}
                        for k in ("single", "pair")}})
    # the tables' kernels; the FFT's launches are its C entries' on the
    # tables path, by symbol
    table_launches = record["tables"]["launches"]
    fft_launches = {k: v for k, v in table_launches.items()
                    if k.startswith("fft_")}
    table_launches = {"banked_transpose": table_launches["banked_transpose"],
                      "fft_stage": sum(fft_launches.values())}
    kernels += [{"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{name}.cu",
                 "replaces": replaces[name],
                 "launches": table_launches[name],
                 "max_abs_err": max(
                     record["table_kernels"]["max_abs_err"][name],
                     record["table_sweep"]["max_abs_err"][name]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"],
                 **({"entries": fft_launches} if name == "fft_stage"
                    else {})}
                for name, t in record["table_times"].items()]
    # the controllers: launches of the bench path, times at the shape where
    # bytes set the time
    bench_err = {BENCH_ROWS[r["name"]]: r["err"]
                 for r in record["bench"]["rows"]}
    big = {"conflict_popcount": POPCOUNT_TIMING[0],
           "carry_arbiter": ARBITER_TIMING[0]}
    for name, shapes in record["controller_times"]["shapes"].items():
        t = shapes[big[name]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/controllers.cu",
            "replaces": replaces[name],
            "launches": record["bench"]["launches"][name],
            "max_abs_err": max(
                record["controllers"]["max_abs_err"][name],
                record["controller_times"]["max_abs_err"][name],
                bench_err[name]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            **({"contract_bound_ms": t["contract_bound_ms"],
                "kernel_alone_device_ms": t["kernel_device_ms"]}
               if name == "carry_arbiter" else {})})
    # the dispatch: launches of the bench path, times at 2^24 requests
    t = record["dispatch_times"]["shapes"][f"{DISPATCH_BIG}x16"]
    kernels.append({
        "name": "moe_dispatch", "route": "cuda",
        "source": "src/repro_torch/csrc/moe_dispatch.cu",
        "replaces": replaces["moe_dispatch"],
        "launches": record["bench"]["launches"]["moe_dispatch"],
        # the bench CLI's launches are the path's; the families and
        # train_families phases' one launch each on jamba's serving and
        # phi3.5-moe's training router stream is held to the router's ref
        "launches_by_path": {
            "bench": record["bench"]["launches"]["moe_dispatch"],
            "families_router_check":
                record["families"]["router_dispatch"]["launches"],
            "train_families_router_check":
                record["train_families"]["router_launches"]},
        "max_abs_err": max(record["dispatch"]["max_abs_err"]["moe_dispatch"],
                           record["dispatch_times"]["max_abs_err"][
                               "moe_dispatch"],
                           bench_err["moe_dispatch"],
                           record["families"]["router_dispatch"][
                               "max_abs_err"],
                           record["train_families"]["router_dispatch"][
                               "max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
