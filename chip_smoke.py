#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
CUDA card: the quickest proof that the port builds, serves and reproduces
the paper's Tables II and III, dispatches MoE requests and runs the kernel
micro-bench on the GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught and passed over):

  1. build   — compile every ``src/repro_torch/csrc/*.cu`` with ``nvcc``,
               one compiler per source, one after another, and print
               the build seconds;
  2. kernels — ``banked_gather`` / ``banked_scatter`` against their plain
               PyTorch versions on the card, bit-equal (tolerance 0: the
               kernels copy bytes), over every bank map, f32 and bf16, full
               and narrow page lines, duplicate scatter indices, and a
               gather after a scatter; a multi-port memory (no banked
               layout) runs the same kernels with one bank;
  3. serve   — full-width llama3.2-1b (random weights from a seeded
               ``torch.Generator``, f32 params, bf16 compute) answers
               4 requests × 64 prompt tokens × 16 new tokens on banked page
               pools (16B, page_len 8); the kernels' launch counts over
               that run must match the path (2 gathers + 2 scatters per KV
               layer and decode step, 2 scatters per KV layer for the
               prefill ingest); the first paged decode step's logits
               equal the dense-cache engine's bit for bit, and a wrong page
               in one request's page table changes that request's logits
               and no other's; the recorded traces against the model-free
               simulation; then both kernels against their plain versions,
               bit-equal, on the serving pool at the path's own shapes
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
               launches are the path's (3 transposes for Table II, 6 FFT
               passes per radix-4 transform, one transform per Table III
               workload); then both kernels against their plain versions
               at the path's shapes (the N×N f32 inputs for N in
               32/64/128, bit-equal; every pass of the 4096-point input,
               rtol = atol = 1e-5, and the whole transform, 2e-3·max|X|);
  6. sweep   — the transpose over (128, 128), (256, 512), (512, 128) and
               (32, 32) × f32/bf16/int32, bit-equal, and the FFT passes
               (4096, 0/3/5), (1024, 2) and whole transforms n = 256, 1024,
               4096 at the reference tests' tolerances;
  7. controllers — ``conflict_popcount`` and ``carry_arbiter`` against
               their plain versions, bit-equal and one launch a call: popcount
               over n_ops 8/256/1024 x B 4/8/16, ids outside [0, B) (negative
               ones too), B = 32, 12 and 6, (8, 12) and (8, 40) lane
               counts and rows off 16-byte alignment; the arbiter at (8, 16),
               (128, 16), (256, 8) and (384, 6), the bank-0 drain, 32-bit
               words that do not drain and int32 words;
  8. dispatch — ``moe_dispatch_positions`` against its plain version,
               bit-equal, with each call's launches counted (one of each of
               its three entries a pass of up to 1024 experts): the CPU
               tests' cases (the reference tests' sweep, the block
               boundary, R = 300, E = 1, 256, 3000 and 0, ids outside
               [0, E), capacity 0 and above R) and 2^24 requests at E = 16
               and E = 128;
  9. bench   — the kernel micro-bench through its CLI entry point
               (``repro_torch.bench.kernel_bench.main``) on the card: the
               six rows in the reference's order, each with err 0, each
               row's kernel launched;
 10. times   — the row kernels at the serving shapes, the transpose (8192 x
               8192 f32) and the FFT (1024 transforms of 4096 points, and its
               first and last pass alone) beside their byte bounds, plain
               versions and library calls; the popcount at 4096 and 2^20 ops
               and the arbiter at 1024 and 2^18 ops (B = 16) beside their
               bounds and plain versions (no library call computes either);
 11. dispatch_times — the dispatch kernel at the bench's shape (8192
               requests, E = 16) and at 2^24 requests (E = 16) beside its
               byte bound and plain version (no library call computes it),
               and the device time of each of its three launches;
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
    from repro_torch.kernels import cuda_lib

    secs = {}
    for name in LIBRARIES:
        t0 = time.perf_counter()
        cuda_lib.library(name)
        secs[name] = time.perf_counter() - t0
    wall = sum(secs.values())
    for name in LIBRARIES:
        text = cuda_lib.build_log(name)
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in text.splitlines() if "registers" in line})
        spills = [line.strip() for line in text.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")]
        log(f"[build] csrc/{name}.cu: {secs[name]:.2f} s; ptxas: {regs} "
            f"registers per thread over the kernels' instances; spills: "
            f"{spills or 'none'}")
    log(f"[build] {len(LIBRARIES)} sources in {wall:.2f} s")
    return {"build_s": wall, "per_source_s": secs}


def phase_kernels() -> dict:
    import torch

    from repro_torch.core import arch as A
    from repro_torch.kernels.banked_gather.ops import (banked_gather,
                                                       banked_gather_plain)
    from repro_torch.kernels.banked_scatter.ops import (banked_scatter,
                                                        banked_scatter_plain)
    archs = ["16B", "16B-offset", "16B-offset-s2", "16B-xor", "16B-fold",
             "8B", "8B-offset", "8B-offset-s2", "8B-xor", "8B-fold",
             "12B", "6B-offset"]
    rng = np.random.default_rng(0)
    err = {"banked_gather": 0.0, "banked_scatter": 0.0}
    cases = 0
    for name in archs:
        lay = A.get(name).layout
        v = lay.n_banks * 48
        for dtype in (torch.float32, torch.bfloat16):
            for d in (4096, 1024, 36):
                table = torch.randn((v, d), device="cuda").to(dtype)
                idx = torch.as_tensor(rng.integers(0, v, 40),
                                      device="cuda")
                got = banked_gather(table, idx, lay.n_banks, lay.mapping,
                                    lay.shift)
                want = banked_gather_plain(table, idx, lay.n_banks,
                                           lay.mapping, lay.shift)
                e_g = (got.float() - want.float()).abs().max().item()
                # scatter with duplicates: every third index repeats one
                sidx = torch.as_tensor(rng.integers(0, v, 24), device="cuda")
                sidx[::3] = sidx[1]
                upd = torch.randn((24, d), device="cuda").to(dtype)
                t_k = banked_scatter(table.clone(), sidx, upd, lay.n_banks,
                                     lay.mapping, lay.shift)
                t_p = banked_scatter_plain(table.clone(), sidx, upd,
                                           lay.n_banks, lay.mapping,
                                           lay.shift)
                e_s = (t_k.float() - t_p.float()).abs().max().item()
                back = banked_gather(t_k, sidx, lay.n_banks, lay.mapping,
                                     lay.shift)
                back_p = banked_gather_plain(t_p, sidx, lay.n_banks,
                                             lay.mapping, lay.shift)
                torch.cuda.synchronize()
                ok = (torch.equal(got, want) and torch.equal(t_k, t_p)
                      and torch.equal(back, back_p))
                if not ok:
                    raise AssertionError(
                        f"kernel != plain on {name} {dtype} D={d}: gather "
                        f"err {e_g}, scatter err {e_s}")
                err["banked_gather"] = max(err["banked_gather"], e_g)
                err["banked_scatter"] = max(err["banked_scatter"], e_s)
                cases += 1
    log(f"[kernels] {cases} cases bit-equal to the plain versions "
        f"({len(archs)} layouts x f32/bf16 x D in 4096/1024/36)")

    # a multi-port memory has no banked layout: the registry runs the same
    # kernels with one bank (the identity map), never the plain version
    from repro_torch import kernels as K
    from repro_torch.kernels.banked_gather.ops import GATHER
    from repro_torch.kernels.banked_scatter.ops import SCATTER
    table = torch.randn((96, 4096), device="cuda").to(torch.bfloat16)
    idx = torch.as_tensor(rng.integers(0, 96, 40), device="cuda")
    idx[::3] = idx[1]
    upd = torch.randn((40, 4096), device="cuda").to(torch.bfloat16)
    g0, s0 = GATHER.launches, SCATTER.launches
    got = K.get("banked_gather").run("4R-1W", table, idx)
    new = K.get("banked_scatter").run("4R-1W", table, idx, upd)
    torch.cuda.synchronize()
    ran = (GATHER.launches - g0, SCATTER.launches - s0)
    same = (torch.equal(got, table[idx]) and torch.equal(
        new, banked_scatter_plain(table.clone(), idx, upd, 1, "lsb")))
    log(f"[kernels] 4R-1W (no banked layout) through the registry: "
        f"launches {ran}, bit-equal to plain: {same}")
    if ran != (1, 1) or not same:
        raise AssertionError("the multi-port route missed the kernels")
    return {"max_abs_err": err, "cases": cases}


def phase_serve() -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.kernels.banked_gather.ops import GATHER
    from repro_torch.kernels.banked_scatter.ops import SCATTER
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

    GATHER.launches = SCATTER.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=NEW)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"banked_gather": GATHER.launches,
                "banked_scatter": SCATTER.launches}
    n_kv, steps = engine.n_kv_layers, NEW - 1
    want = {"banked_gather": 2 * n_kv * steps,
            "banked_scatter": 2 * n_kv * steps + 2 * n_kv}
    log(f"[serve] llama3.2-1b full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}): {BATCH} requests x {PROMPT} prompt + {NEW} new "
        f"tokens in {secs:.3f} s = {BATCH * NEW / secs:.1f} tokens/s "
        f"(prefill included)")
    log(f"[serve] launches on the path: {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
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
    return {"engine": engine, "launches": launches, "tokens_per_s":
            BATCH * NEW / secs, "generate_s": secs, "logit_err": logit_err,
            "logit_scale": scale, "wrong_page_logit_change": wrong,
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
    """The row kernels' inputs at the serve phase's shapes: its pool
    (n_pages x row_width, compute dtype, random contents), the batch's
    page lists (one decode step's gather), each sequence's current page
    (one decode step's append) and the prompt pages (the prefill ingest),
    with update rows for both scatters."""
    import torch
    kv, lay = engine.kv_cfg, engine.mem_arch.layout
    pt = engine.last_pages.page_table
    dtype = getattr(torch, engine.rc.compute_dtype)
    n_pref = -(-PROMPT // PAGE_LEN)
    ids = {"read": pt.clamp(min=0).reshape(-1),
           "append": pt[:, (PROMPT + NEW - 2) // PAGE_LEN].clamp(min=0),
           "ingest": pt[:, :n_pref].clamp(min=0).reshape(-1)}
    return {"kv": kv, "dtype": dtype, "ids": ids,
            "args": (lay.n_banks, lay.mapping, lay.shift),
            "pool": torch.randn((kv.n_pages, kv.row_width),
                                device="cuda").to(dtype),
            "upd": {k: torch.randn((ids[k].shape[0], kv.row_width),
                                   device="cuda").to(dtype)
                    for k in ("append", "ingest")}}


def phase_path_kernels(engine) -> dict:
    """Both kernels against their plain versions, bit-equal, on the
    serving pool at the shapes the serve phase gave them."""
    import torch

    from repro_torch.kernels.banked_gather.ops import (banked_gather,
                                                       banked_gather_plain)
    from repro_torch.kernels.banked_scatter.ops import (banked_scatter,
                                                        banked_scatter_plain)
    inp = _serving_inputs(engine)
    pool, ids, args = inp["pool"], inp["ids"], inp["args"]
    err = {"banked_gather": 0.0, "banked_scatter": 0.0}

    def held(name, what, got, want):
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        err[name] = max(err[name], e)
        log(f"[path] {name}, {what}: {tuple(got.shape)} {got.dtype}, "
            f"bit-equal to plain: {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain at {what} (err {e})")

    held("banked_gather", f"decode read of {ids['read'].shape[0]} lines",
         banked_gather(pool, ids["read"], *args),
         banked_gather_plain(pool, ids["read"], *args))
    for step in ("append", "ingest"):
        k = banked_scatter(pool.clone(), ids[step], inp["upd"][step], *args)
        p = banked_scatter_plain(pool.clone(), ids[step], inp["upd"][step],
                                 *args)
        held("banked_scatter", f"{step} of {ids[step].shape[0]} lines", k, p)
        held("banked_gather", f"decode read after the {step}",
             banked_gather(k, ids["read"], *args),
             banked_gather_plain(p, ids["read"], *args))
    return {"max_abs_err": err}


def phase_times(engine) -> dict:
    import torch

    from repro_torch.bench.kernel_bench import bound_ms, graph_ms, time_ms
    from repro_torch.core.arch import physical_row_of
    from repro_torch.kernels.banked_gather.ops import (banked_gather,
                                                       banked_gather_plain)
    from repro_torch.kernels.banked_scatter.ops import (banked_scatter,
                                                        banked_scatter_plain)
    inp = _serving_inputs(engine)
    kv, dtype, pool, args = inp["kv"], inp["dtype"], inp["pool"], inp["args"]
    lay = engine.mem_arch.layout
    rpb = kv.n_pages // lay.n_banks
    # one decode step's shapes: the page lists of the batch (gather) and
    # each sequence's current page (scatter)
    read_ids, cur_ids = inp["ids"]["read"], inp["ids"]["append"]
    upd = inp["upd"]["append"]
    read_phys = physical_row_of(read_ids, lay.n_banks, rpb, lay.mapping,
                                lay.shift)
    cur_phys = physical_row_of(cur_ids, lay.n_banks, rpb, lay.mapping,
                               lay.shift)
    elt = pool.element_size()

    def bound(n: int) -> float:
        # each input read once, each output written once: n rows in, n rows
        # out, n int64 indices
        return bound_ms(2 * n * kv.row_width * elt + 8 * n)[0]

    out = {}
    for name, n, kern, plain, lib in (
            ("banked_gather", read_ids.shape[0],
             lambda: banked_gather(pool, read_ids, *args),
             lambda: banked_gather_plain(pool, read_ids, *args),
             lambda: torch.index_select(pool, 0, read_phys)),
            ("banked_scatter", cur_ids.shape[0],
             lambda: banked_scatter(pool, cur_ids, upd, *args),
             lambda: banked_scatter_plain(pool, cur_ids, upd, *args),
             lambda: pool.index_copy_(0, cur_phys, upd))):
        # per call from Python, back to back: plain, kernel, kernel, plain
        # (and the yardstick) in one call; then the device time alone
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kern), time_ms(kern),
                          time_ms(plain))
        out[name] = {"rows": int(n), "row_width": kv.row_width,
                     "dtype": str(dtype), "ms": min(k1, k2),
                     "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
                     "plain_ms_runs": [p1, p2], "library_ms": time_ms(lib),
                     "device_ms": graph_ms(kern),
                     "library_device_ms": graph_ms(lib),
                     "bound_ms": bound(n)}
        r = out[name]
        us = {k: v * 1e3 for k, v in r.items() if k.endswith("ms")}
        log(f"[times] {name}: {n} rows x {kv.row_width} {dtype}, per call "
            f"from Python: kernel {us['ms']:.2f} us, plain "
            f"{us['plain_ms']:.2f} us, library {us['library_ms']:.2f} us; "
            f"device time in a CUDA graph: kernel {us['device_ms']:.3f} us, "
            f"library {us['library_device_ms']:.3f} us; bound "
            f"{us['bound_ms']:.3f} us (bytes)")
    return out


def phase_tables() -> dict:
    """The paper tables' path through its CLI entry point, held to the CPU
    pricing, the pins, the reproduction tolerances and the path's launch
    counts."""
    import torch

    from repro_torch.bench import paper_tables as PT
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE
    from repro_torch.kernels.fft_stage.ops import STAGE

    TRANSPOSE.launches = STAGE.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = PT.main(["table2", "table3"])          # prints the rows
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"banked_transpose": TRANSPOSE.launches,
                "fft_stage": STAGE.launches}
    want = {"banked_transpose": len(PT.SIZES),
            "fft_stage": 6 * len(PT.RADICES)}
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


def _check_fft_full(x, err, what) -> None:
    """The kernel transform against the plain passes and the numpy oracle,
    atol 2e-3·max|X| (tests/test_kernels.py:153-154)."""
    import torch

    from repro_torch.kernels.fft_stage import (fft4096_radix4,
                                               fft_oracle_digit_reversed,
                                               fft_radix4_ref)
    n = x.shape[-1]
    got = fft4096_radix4(x, n=n)
    plain = fft_radix4_ref(x, n=n)
    torch.cuda.synchronize()
    xs = x.cpu().numpy()
    oracle = np.stack([fft_oracle_digit_reversed(row, 4) for row in xs])
    tol = 2e-3 * np.abs(oracle).max()
    e_plain = (got - plain).abs().max().item()
    e_oracle = float(np.abs(got.cpu().numpy() - oracle).max())
    err["fft_stage"] = max(err["fft_stage"], e_plain)
    log(f"[{what}] fft4096_radix4 n={n} on {tuple(x.shape)}: max |kernel - "
        f"plain| {e_plain:.3g}, max |kernel - oracle| {e_oracle:.3g} "
        f"(tolerance {tol:.3g})")
    if e_plain > tol or e_oracle > tol:
        raise AssertionError(f"fft transform n={n} off by {e_plain:.3g} / "
                             f"{e_oracle:.3g} > {tol:.3g}")


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
    return {"max_abs_err": err}


TRANSPOSE_TIMING = (8192, 8192)     # f32: 512 MiB moved
FFT_TIMING = (1024, 4096)           # complex64 transforms: 64 MiB moved


def phase_table_times() -> dict:
    import torch

    from repro_torch.bench.kernel_bench import bound_ms, timed
    from repro_torch.kernels.banked_transpose.ops import banked_transpose
    from repro_torch.kernels.banked_transpose.ref import banked_transpose_ref
    from repro_torch.kernels.fft_stage import (fft4096_radix4,
                                               fft_radix4_ref)
    from repro_torch.kernels.fft_stage.ops import (fft_stage,
                                                   stage_twiddles)
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

    batch, nf = FFT_TIMING
    z = torch.complex(torch.randn((batch, nf), device="cuda", generator=gen),
                      torch.randn((batch, nf), device="cuda", generator=gen))
    passes = 6
    # the function: each complex64 input read once, each output written
    # once; 40 flops per radix-4 butterfly column, nf/4 columns per pass
    flops = batch * passes * (nf // 4) * 40
    out["fft_stage"] = timed(
        lambda: fft4096_radix4(z, n=nf), lambda: fft_radix4_ref(z, n=nf),
        lambda: torch.fft.fft(z), bound_ms(2 * batch * nf * 8, flops),
        graph_iters=20, iters=50)
    out["fft_stage"]["shape"] = [batch, nf]
    # one pass alone (the kernel's own unit): two f32 planes in and out
    # plus the pass's twiddles
    xr, xi = z.real.contiguous(), z.imag.contiguous()
    per_pass = {}
    for p in (0, passes - 1):
        sub = nf // 4 ** (p + 1)
        twr, twi = stage_twiddles(nf, p, xr.device)
        vr, vi = xr.reshape(-1, 4, sub), xi.reshape(-1, 4, sub)
        per_pass[p] = timed(
            lambda: fft_stage(vr, vi, twr, twi),
            lambda: fft_stage_ref(vr, vi, twr, twi), None,
            bound_ms(4 * batch * nf * 4 + 2 * 4 * sub * 4,
                      batch * (nf // 4) * 40), graph_iters=20, iters=50)
    out["fft_stage"]["passes"] = per_pass
    # what the six-launch design must move at least: six passes' bytes
    out["fft_stage"]["design_bound_ms"] = sum(
        bound_ms(4 * batch * nf * 4 + 2 * 4 * (nf // 4 ** (p + 1)) * 4)[0]
        for p in range(passes))
    for name, r in out.items():
        us = {k: (v * 1e3 if isinstance(v, float) else v)
              for k, v in r.items() if k.endswith("ms")}
        lib = "library" if name == "banked_transpose" else "torch.fft.fft"
        log(f"[times] {name} at {r['shape']}: per call from Python: kernel "
            f"{us['ms']:.2f} us, plain {us['plain_ms']:.2f} us, {lib} "
            f"{us['library_ms']:.2f} us; device time in a CUDA graph: kernel "
            f"{us['device_ms']:.3f} us, {lib} {us['library_device_ms']:.3f} "
            f"us; bound {us['bound_ms']:.3f} us ({r['bound_by']})")
    for p, r in per_pass.items():
        log(f"[times] fft_stage pass {p} alone at {list(FFT_TIMING)}: per "
            f"call kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us; device {r['device_ms'] * 1e3:.3f}"
            f" us; bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
    log(f"[times] fft_stage: six passes' bytes bound the six-launch design "
        f"at {out['fft_stage']['design_bound_ms'] * 1e3:.3f} us")
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


def phase_controllers() -> dict:
    """Both controller kernels against their plain versions on the card:
    the reference tests' sweeps (tests/test_kernels.py:58-97) and the edge
    cases (ids outside [0, B), lane counts other than 16, unaligned rows,
    bank counts without a template, words that do not drain)."""
    import torch

    from repro_torch.core.arbiter import pack_requests
    from repro_torch.core.conflicts import bank_onehot
    from repro_torch.kernels.carry_arbiter.ops import (ARBITER, carry_arbiter,
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
            ("(384, 6)", cuda(rng.integers(0, 2 ** 16, (384, 6))))]
    for what, reqs in arb:
        _held("carry_arbiter", ARBITER, what, lambda: carry_arbiter(reqs),
              lambda: carry_arbiter_plain(reqs), err)
    bank0 = carry_arbiter(drain)[0, :, 0].cpu()
    ones = ((bank0 & (bank0 - 1)) == 0) & (bank0 != 0)
    drained = bool(ones.all()) and int(np.bitwise_or.reduce(
        bank0.numpy())) == 0xFFFF
    log(f"[controllers] bank 0 grants one distinct lane a cycle for 16 "
        f"cycles: {drained}")
    if not drained:
        raise AssertionError("the arbiter does not drain 16 requests")
    return {"max_abs_err": err, "cases": {"conflict_popcount": len(pop),
                                          "carry_arbiter": len(arb)}}


def _entries() -> dict:
    """Every kernel's C entry (its launch count), by kernel name; the
    dispatch's is the sum over its three entries."""
    from repro_torch.kernels.banked_gather.ops import GATHER
    from repro_torch.kernels.banked_scatter.ops import SCATTER
    from repro_torch.kernels.banked_transpose.ops import TRANSPOSE
    from repro_torch.kernels.carry_arbiter.ops import ARBITER
    from repro_torch.kernels.conflict_popcount.ops import POPCOUNT
    from repro_torch.kernels.fft_stage.ops import STAGE
    from repro_torch.kernels.moe_dispatch.ops import DISPATCH
    return {"banked_gather": GATHER, "banked_scatter": SCATTER,
            "banked_transpose": TRANSPOSE, "fft_stage": STAGE,
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
    return {"rows": rows, "launches": launches, "seconds": secs}


POPCOUNT_TIMING = (1 << 20, 16)     # ops, banks: 138,412,032 bytes moved
ARBITER_TIMING = (1 << 18, 16)      # ops, banks: 285,212,672 bytes moved


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
        # the function on 32-bit words: (n, b) in, (n, 16, b) out
        r = timed(lambda: carry_arbiter(reqs),
                  lambda: carry_arbiter_plain(reqs), None,
                  bound_ms(n * b * 4 + n * 16 * b * 4), graph_iters=20,
                  iters=50)
        # the kernel alone on 32-bit words, without the wrapper's int64
        # conversions at its boundary
        r["kernel_device_ms"] = graph_ms(lambda: arbiter_words(words), 20)
        out["carry_arbiter"][n] = r
    for name, shapes in out.items():
        for n, r in shapes.items():
            us = {k: (v * 1e3 if isinstance(v, float) else v)
                  for k, v in r.items() if k.endswith("ms")}
            alone = (f", the kernel alone {us['kernel_device_ms']:.3f} us"
                     if "kernel_device_ms" in us else "")
            log(f"[times] {name} at {n} ops: per call from Python: kernel "
                f"{us['ms']:.2f} us, plain {us['plain_ms']:.2f} us; device "
                f"time in a CUDA graph: kernel {us['device_ms']:.3f} us"
                f"{alone}; bound {us['bound_ms']:.3f} us ({r['bound_by']}); "
                f"library: none")
    return {"shapes": out, "max_abs_err": err}


DISPATCH_BIG = 1 << 24               # requests: 150,994,944 bytes moved


def _held_dispatch(what, experts, n_experts, capacity, err, tag) -> None:
    """One dispatch call against its plain version on the same CUDA ids:
    ``pos`` and ``kept`` bit-equal (integers: tolerance 0), and one launch
    of each of the three entries a pass of up to 1024 experts (the rank
    launch alone with no experts)."""
    import torch

    from repro_torch.kernels.moe_dispatch.ops import (EXPERT_CHUNK, HIST,
                                                      RANK, SCAN,
                                                      moe_dispatch_plain,
                                                      moe_dispatch_positions)
    entries = (HIST, SCAN, RANK)
    before = [e.launches for e in entries]
    got = moe_dispatch_positions(experts, n_experts, capacity)
    ran = [e.launches - b for e, b in zip(entries, before)]
    want = moe_dispatch_plain(experts, n_experts, capacity)
    torch.cuda.synchronize()
    same = all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want, strict=True))
    e = max((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
            for g, w in zip(got, want))
    err["moe_dispatch"] = max(err["moe_dispatch"], float(e))
    passes = -(-n_experts // EXPERT_CHUNK)
    expect = [passes, passes, max(passes, 1)]
    log(f"[{tag}] moe_dispatch, {what}: bit-equal to plain: {same}, "
        f"launches (hist, scan, rank) {ran}")
    if not same or ran != expect:
        raise AssertionError(f"moe_dispatch at {what}: equal {same}, max "
                             f"|diff| {e}, launches {ran} != {expect}")


def phase_dispatch() -> dict:
    """The dispatch kernel against its plain version on the card: the CPU
    tests' cases (tests/test_torch_dispatch.py: the reference tests' sweep
    and block boundary, the edge cases, several passes of experts) and
    2^24 requests at E = 16 and E = 128; every call's launches counted."""
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
        ("R=2^24, E=16, cap=2^20", ids(0, 16, DISPATCH_BIG), 16, 1 << 20),
        ("R=2^24, E=128, cap=2^17", ids(0, 128, DISPATCH_BIG), 128,
         1 << 17),
    ]
    for what, experts, e, cap in cases:
        _held_dispatch(what, experts, e, cap, err, "dispatch")
    n_cases = len(cases)
    cases.clear()                     # the 2^24 inputs
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "cases": n_cases}


def phase_dispatch_times() -> dict:
    """The dispatch kernel at the bench's shape and at 2^24 requests (E =
    16), held to its plain version first: per call, device time in a CUDA
    graph, each launch's device time (torch.profiler) and the byte bound
    (4 bytes read, 4 + 1 written a request)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench.kernel_bench import bound_ms, timed
    from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                      moe_dispatch_positions)
    gen = torch.Generator(device="cuda").manual_seed(8)
    out, err = {}, {"moe_dispatch": 0.0}
    for r, cap in ((8192, 1024), (DISPATCH_BIG, 1 << 20)):
        experts = torch.randint(0, 16, (r,), device="cuda", generator=gen,
                                dtype=torch.int32)
        _held_dispatch(f"R={r}, E=16, cap={cap}", experts, 16, cap, err,
                       "times")

        def call(experts=experts, cap=cap):
            return moe_dispatch_positions(experts, 16, cap)
        t = timed(call, lambda experts=experts, cap=cap: moe_dispatch_plain(
                      experts, 16, cap), None,
                  bound_ms(r * (4 + 4 + 1)), graph_iters=20, iters=50)
        # where the device time goes: each of the three launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        t["launch_device_ms"] = {
            name: ev.self_device_time_total / ev.count / 1e3
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            for name in ("dispatch_hist", "dispatch_scan", "dispatch_rank")
            if name in ev.key and ev.count}
        out[r] = t
        us = {k: v * 1e3 for k, v in t.items()
              if k.endswith("ms") and isinstance(v, float)}
        split = ", ".join(f"{k} {v * 1e3:.3f} us"
                          for k, v in t["launch_device_ms"].items())
        log(f"[times] moe_dispatch at {r} requests, E=16: per call from "
            f"Python: kernel {us['ms']:.2f} us, plain {us['plain_ms']:.2f} "
            f"us; device time in a CUDA graph: kernel {us['device_ms']:.3f} "
            f"us (3 launches); per launch (torch.profiler, 5 calls): "
            f"{split}; bound {us['bound_ms']:.3f} us ({t['bound_by']}); "
            f"library: none")
        if len(t["launch_device_ms"]) != 3:
            raise AssertionError(f"the profiler saw {t['launch_device_ms']}"
                                 f", not the three dispatch launches")
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
    kernels = [{"name": name, "route": "cuda",
                "source": "src/repro_torch/csrc/banked_rows.cu",
                "replaces": replaces[name],
                "launches": serve["launches"][name],
                "max_abs_err": max(
                    record["kernels"]["max_abs_err"][name],
                    record["path_kernels"]["max_abs_err"][name]),
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes",
                "library_ms": t["library_ms"]}
               for name, t in record["times"].items()]
    kernels += [{"name": name, "route": "cuda",
                 "source": f"src/repro_torch/csrc/{name}.cu",
                 "replaces": replaces[name],
                 "launches": record["tables"]["launches"][name],
                 "max_abs_err": max(
                     record["table_kernels"]["max_abs_err"][name],
                     record["table_sweep"]["max_abs_err"][name]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t["library_ms"]}
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
            "library_ms": None})
    # the dispatch: launches of the bench path, times at 2^24 requests
    t = record["dispatch_times"]["shapes"][DISPATCH_BIG]
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
