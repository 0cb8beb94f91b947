#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
CUDA card: the quickest proof that the port builds and serves on the GPU.

    python3 chip_smoke.py

Phases (each failure exits non-zero; nothing is caught and passed over):

  1. build   — compile ``src/repro_torch/csrc/banked_rows.cu`` with
               ``nvcc`` and print the build seconds;
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
  5. times   — each kernel at the serving shapes, beside its bound, its
               plain version and the one-call PyTorch yardstick: per call
               from Python (CUDA events over back-to-back calls) and, for
               the kernel and the yardstick, device time alone (calls
               replayed from one CUDA graph);
  6. profile — ``torch.profiler`` over a short generation: device busy
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

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate (data sheet)
PROMPT, NEW, BATCH, PAGE_LEN = 64, 16, 4, 8
MAX_SEQ = PROMPT + NEW         # a whole number of pages: paged and dense
                               # attention then run the same shapes


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> dict:
    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.library("banked_rows")
    secs = time.perf_counter() - t0
    text = cuda_lib.build_log("banked_rows")
    regs = sorted({int(line.split("Used ")[1].split()[0])
                   for line in text.splitlines() if "registers" in line})
    spills = [line.strip() for line in text.splitlines()
              if "spill" in line and not line.strip().startswith("0 ")]
    log(f"[build] csrc/banked_rows.cu: {secs:.2f} s; ptxas: {regs} "
        f"registers per thread over the kernels' instances; spills: "
        f"{spills or 'none'}")
    return {"build_s": secs}


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


def _time_ms(fn, iters: int = 200) -> float:
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int = 100) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so no host dispatch sits between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
        return (2 * n * kv.row_width * elt + 8 * n) / HBM_BYTES_PER_S * 1e3

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
        p1, k1, k2, p2 = (_time_ms(plain), _time_ms(kern), _time_ms(kern),
                          _time_ms(plain))
        out[name] = {"rows": int(n), "row_width": kv.row_width,
                     "dtype": str(dtype), "ms": min(k1, k2),
                     "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
                     "plain_ms_runs": [p1, p2], "library_ms": _time_ms(lib),
                     "device_ms": _graph_ms(kern),
                     "library_device_ms": _graph_ms(lib),
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
    record["times"] = phase_times(engine)
    record["profile"] = phase_profile(engine)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    record["nvidia_smi"] = smi
    record["torch"] = torch.__version__
    record["cuda"] = torch.version.cuda
    record["wall_s"] = time.perf_counter() - t_start

    replaces = {"banked_gather": "src/repro/kernels/banked_gather/kernel.py:74",
                "banked_scatter":
                    "src/repro/kernels/banked_scatter/kernel.py:66"}
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
