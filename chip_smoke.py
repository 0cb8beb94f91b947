#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
CUDA card: the quickest proof that the port builds, serves and reproduces
the paper's Tables II and III, dispatches MoE requests and runs the kernel
micro-bench on the GPU.

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
 12. profile — ``torch.profiler`` over a short generation: device busy
               share and the ops that take the time.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

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


def phase_serve() -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.banked_gather import ops as G
    from repro_torch.kernels.banked_scatter import ops as S
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

    # every call of a plain version during the run is counted: on CUDA
    # tensors the wrappers must launch their kernels, never these
    plain_calls = {"banked_gather_plain": 0, "banked_scatter_plain": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def call(*args, **kw):
            plain_calls[name] += 1
            return fn(*args, **kw)
        return fn, call

    originals = {}
    for mod, name in ((G, "banked_gather_plain"), (S, "banked_scatter_plain")):
        originals[mod, name], patched = counted(mod, name)
        setattr(mod, name, patched)
    G.GATHERS.launches = S.SCATTERS.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=NEW)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        for (mod, name), fn in originals.items():
            setattr(mod, name, fn)
    launches = {"banked_gather": G.GATHERS.launches,
                "banked_scatter": S.SCATTERS.launches}
    entries = {"banked_gather": G.GATHERS.by_entry(),
               "banked_scatter": S.SCATTERS.by_entry()}
    n_kv, steps = engine.n_kv_layers, NEW - 1
    # one launch per KV layer for its K and V pools: a gather and an
    # append per decode step, one ingest per layer after the prefill
    want = {"banked_gather": n_kv * steps,
            "banked_scatter": n_kv * steps + n_kv}
    log(f"[serve] llama3.2-1b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}): {BATCH} requests x {PROMPT} prompt + {NEW} new "
        f"tokens in {secs:.3f} s = {BATCH * NEW / secs:.1f} tokens/s "
        f"(prefill included)")
    log(f"[serve] launches on the path: {launches} (expected {want}); by "
        f"entry: {entries}; plain versions called: {plain_calls}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if (entries["banked_gather"]["banked_gather_pair_launch"]
            != want["banked_gather"]
            or entries["banked_scatter"]["banked_scatter_pair_launch"]
            != want["banked_scatter"] or any(plain_calls.values())):
        raise AssertionError(f"the path left the paired kernels: {entries}, "
                             f"plain calls {plain_calls}")
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


def _profiled_kernels(fn, tries: int = 3) -> list:
    """The CUDA kernels (profiler events, in start order) that ``fn`` runs,
    by torch.profiler after a warm-up call: the session brackets ``fn``
    between two ``fill_`` marker kernels and keeps what lies between.  A
    short session now and then records no CUDA event at all; one that
    lacks its markers is taken again, up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    mark = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mark.fill_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
            mark.fill_(2)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        # the two markers are the first and the last kernel
        if len(kernels) >= 2 and kernels[0].name == kernels[-1].name:
            return kernels[1:-1]
    raise AssertionError(f"torch.profiler recorded no marker kernels in "
                         f"{tries} sessions")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.manual_seed(0)
    t_start = time.perf_counter()
    record = {"build": phase_build()}
    record["kernels"] = phase_kernels()
    serve = phase_serve()
    engine = serve.pop("engine")
    record["serve"] = serve
    record["path_kernels"] = phase_path_kernels(engine)
    record["cost"] = phase_cost(engine)
    record["tables"] = phase_tables()
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
    record["profile"] = phase_profile(engine)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
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
    # the row kernels: launches of the serving path (by entry too), times
    # where bytes rule (single table, 16384 lines), the serving shapes'
    # single and paired times beside them
    kernels = []
    for name in ("banked_gather", "banked_scatter"):
        t = record["row_times"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/banked_rows.cu",
            "replaces": replaces[name],
            "launches": serve["launches"][name],
            "entries": serve["entries"][name],
            "max_abs_err": max(record["kernels"]["max_abs_err"][name],
                               record["path_kernels"]["max_abs_err"][name],
                               record["row_times"]["max_abs_err"][name]),
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
        "max_abs_err": max(record["dispatch"]["max_abs_err"]["moe_dispatch"],
                           record["dispatch_times"]["max_abs_err"][
                               "moe_dispatch"],
                           bench_err["moe_dispatch"]),
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
