"""One run of one cell: set-up, the measured window through
``ServeEngine.run_scheduler``, the check against the reference, and the
result line.

Set-up builds the configuration's ``ModelConfig``, makes the weights on
the device from the seed in bfloat16 (a ``torch.Generator`` on the card,
one call a stacked leaf), builds the engine on banked page pools and
drives a seeded day (``traffic.make_day``) through
``ServeEngine.run_scheduler`` with ``WindowScheduler``, which stamps
``time.perf_counter()`` at each tick's entry.  Each tick's device work
ends in the engine's one sync (the sampled tokens' copy to the host), so
consecutive stamps bracket one tick.  The window opens once the day has
run as many ticks as the mix's longest output (lane occupancy has reached
its level; up to then the run is set-up) and closes at the first tick
boundary ``seconds`` later, where ``WindowScheduler.run`` stops yielding.
Nothing is added to the program: no CUDA graph, no ``torch.compile``.

After the window: the peak device memory is read, the program's pools are
freed, and a sample of the finished requests, the longest among them, is
replayed through the float32 reference (``reference.py``) over each
prompt and its served tokens.  ``correct`` holds where no served token's
reference logit lies further below the reference's best than the cell's
limit (``limits/<cell>.json``).
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from h100_bench import reference, traffic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: seconds of the window that ``--trace 1`` records with torch.profiler,
#: from the window's first tick (the per-layer metrics that read it)
TRACE_SECONDS = 3.0
#: served tokens the check wants at least; requests sampled until reached
CHECK_TOKENS = 320
CHECK_MAX_REQUESTS = 24
#: top-level module names that may not be loaded when the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the profiler's names of the row kernels (csrc/banked_rows.cu)
ROW_KERNELS = ("gather_rows", "scatter_rows_staged", "scatter_claim",
               "scatter_rows_claimed")


class DayExhausted(RuntimeError):
    pass


def load_json(*parts) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def model_config(cfg_json: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**cfg_json["model"])


def make_weights(cfg, seed: int, device) -> dict:
    """The parameter tree the program serves, in bfloat16, from ``seed``:
    one draw on the device a stacked leaf, N(0, scale^2) at the program's
    spec scales (1 / sqrt(fan-in)), norms at one, and the embedding at
    1 / sqrt(d_model) too.  At the spec's scale of 1 the embedding rows
    outweigh the layers' outputs in the residual stream, and a tied head
    then predicts the input token by a margin of hundreds, which no
    rounding could flip; a trained model's embedding rows are small."""
    import dataclasses
    from repro_torch.models import model_specs
    from repro_torch.models.params import tree_map_leaves
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    specs = model_specs(cfg)
    specs["embed"] = dataclasses.replace(specs["embed"],
                                         scale=cfg.d_model ** -0.5)

    def make(leaf):
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=torch.bfloat16,
                              device=device)
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=torch.bfloat16,
                               device=device)
        x = torch.randn(leaf.shape, generator=gen, dtype=torch.bfloat16,
                        device=device)
        return x.mul_(leaf.scale)
    return tree_map_leaves(make, specs)


def scheduler_class():
    """``WindowScheduler``, a ``Scheduler`` that keeps the window (the
    program's module is imported when a run starts, not with this one)."""
    from repro_torch.serving.scheduler import Scheduler

    class WindowScheduler(Scheduler):
        """Stamps each tick's entry, records what each tick did, opens the
        window after ``warm_ticks`` ticks and stops yielding at the first
        tick boundary ``seconds`` after it opened.  ``hook(index)`` runs
        at each tick boundary before the stamp (the traced run's profiler
        starts and stops there); the seconds it takes are kept apart
        (``pauses``) and taken out of the window's timeline."""

        def __init__(self, *args, warm_ticks: int, seconds: float,
                     window_ticks: int | None = None, **kwargs):
            super().__init__(*args, **kwargs)
            self.warm_ticks, self.seconds, self.hook = warm_ticks, seconds, \
                None
            #: a window of this many ticks instead of ``seconds`` (the CPU
            #: tests, whose runs must not depend on the host's speed)
            self.window_ticks = window_ticks
            #: per tick: entry stamp, ``now`` at entry, host seconds inside
            #: ``tick``, admissions (rid, prompt_len), the decode step's
            #: lanes (rid, or -1 where idle), positions and page table, and
            #: the lanes and KV pages held after it; the hook's seconds
            #: before its stamp
            self.stamps, self.nows, self.host, self.admitted = [], [], [], []
            self.pauses = []
            self.rids, self.pos, self.tables, self.held = [], [], [], []
            self.pages = []
            self.t_open = self.t_close = None

        def tick(self):
            i = len(self.stamps)
            h0 = time.perf_counter()
            if self.hook is not None:
                self.hook(i)
            t = time.perf_counter()
            self.pauses.append(t - h0 if self.hook is not None else 0.0)
            if i == self.warm_ticks:
                self.t_open = t
            self.stamps.append(t)
            self.nows.append(self.now)
            ev = super().tick()
            self.host.append(time.perf_counter() - t)
            self.admitted.append([(a.request.rid, a.request.prompt_len)
                                  for a in ev.admitted])
            self.rids.append(np.where(ev.active, self.lane_rid, -1)
                             if ev.decoded else None)
            self.pos.append(ev.pos if ev.decoded else None)
            self.tables.append(ev.page_table if ev.decoded else None)
            self.held.append(int((self.lane_rid >= 0).sum()))
            self.pages.append(int((self.page_table >= 0).sum()))
            return ev

        def run(self, requests=None):
            if requests is not None:
                self.submit(requests)
            while True:
                t = time.perf_counter()
                if self.t_open is not None and (
                        t >= self.t_open + self.seconds
                        if self.window_ticks is None else
                        len(self.stamps) >= self.warm_ticks
                        + self.window_ticks):
                    self.t_close = t
                    if self.hook is not None:
                        self.hook(len(self.stamps))
                    return
                if self.done():
                    raise DayExhausted(
                        f"the day ran out after {len(self.stamps)} ticks, "
                        f"before the window closed")
                yield self.tick()

    return WindowScheduler


class Tracer:
    """``--trace 1``: torch.profiler over the window's first
    ``TRACE_SECONDS``, started and stopped at tick boundaries (the device
    is idle there: the previous tick ended in the engine's sync), and
    ``record_function`` spans around the calls into the scheduler and the
    engine that the idle gaps are named by."""

    SPANS = ("sched.tick", "engine.admit", "engine.step")

    def __init__(self, sched_cls, engine, cuda: bool):
        from torch.profiler import ProfilerActivity, profile, record_function
        self.cuda = cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        self.prof = profile(activities=acts)
        self.start = self.stop = None
        self.first = self.last = None       # traced tick indices [first, last)

        def span(name, fn):
            def wrapped(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return wrapped
        engine._ingest_request = span("engine.admit", engine._ingest_request)
        engine._scheduler_step = span("engine.step", engine._scheduler_step)
        base_tick = sched_cls.tick

        def tick(sched):
            with record_function("sched.tick"):
                return base_tick(sched)
        self.sched_cls = type("TracedScheduler", (sched_cls,),
                              {"tick": tick})

    def hook(self, sched):
        def at_tick(i):
            if self.start is None and i == sched.warm_ticks:
                self._sync()
                self.prof.start()
                self.start, self.first = time.perf_counter(), i
            elif self.start is not None and self.stop is None and (
                    time.perf_counter() >= self.start + TRACE_SECONDS
                    or sched.t_close is not None):
                self._sync()
                self.stop, self.last = time.perf_counter(), i
                self.prof.stop()
        return at_tick

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def summary(self) -> dict:
        """busy_s, window_s, the row kernels' device seconds, the device
        ops and idle gaps of the traced window, and its ticks."""
        dev = torch.autograd.DeviceType.CUDA
        events = self.prof.events()
        # the device's own events: kernels, copies and sets (the spans'
        # annotations on the device's timeline are left out)
        kern = sorted(((e.time_range.start, e.time_range.end,
                        _short(e.name)) for e in events
                       if e.device_type == dev and e.name not in self.SPANS),
                      key=lambda k: k[0])
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in events if e.name in self.SPANS)
        by_name: dict = {}
        for s, e, name in kern:
            by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
        rows_s = sum(v for k, v in by_name.items()
                     if any(r in k for r in ROW_KERNELS))
        busy, gaps, end = 0.0, {}, None
        for s, e, _ in kern:
            if end is not None and s > end:
                label = _span_at(spans, (s + end) / 2)
                gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-6
            if end is None or s > end:
                busy += (e - s) * 1e-6
                end = e
            elif e > end:
                busy += (e - end) * 1e-6
                end = e
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy, "window_s": self.stop - self.start,
                "rows_device_s": rows_s, "ticks": (self.first, self.last),
                "device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:10]]}


def _short(name: str) -> str:
    """A kernel's name without the namespaces and return type that make
    PyTorch's elementwise kernels hundreds of characters long."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "c10::", "at::"):
        name = name.replace(junk, "")
    return name[:160]


def _span_at(spans, t) -> str:
    """The innermost harness span open at time ``t`` (profiler time)."""
    inner = "between spans"
    for s, e, name in spans:
        if s > t:
            break
        if e >= t:
            inner = name
    return inner


def _rows_bytes(sched, kv, first: int, last: int) -> float:
    """The bytes the paired row launches of ticks [first, last) need for
    the indices they were given, K and V, 8 bytes an index: a gather reads
    each named row once and writes every output row (every lane's page
    list, unmapped entries naming page 0); a scatter reads each distinct
    target's row from its update and writes it once (each lane's current
    page, an idle lane's the scratch page; each admission's prompt
    pages)."""
    row = kv.row_width * 2                       # bf16 bytes of one page
    total = 0.0
    for i in range(first, last):
        for _, plen in sched.admitted[i]:
            n = -(-plen // kv.page_len)
            total += sched.n_kv_layers * (2 * 2 * n * row + 8 * n)
        pt = sched.tables[i]
        if pt is None:
            continue
        ids = np.maximum(pt, 0).reshape(-1)
        pg = np.minimum(sched.pos[i] // kv.page_len, pt.shape[1] - 1)
        cur = np.where(sched.rids[i] >= 0,
                       np.maximum(pt[np.arange(pt.shape[0]), pg], 0),
                       sched.scratch_page or 0)
        total += sched.n_kv_layers * (
            2 * (np.unique(ids).size + ids.size) * row + 8 * ids.size
            + 2 * 2 * np.unique(cur).size * row + 8 * cur.size)
    return total


def load_metric(name: str):
    """``metrics/<name>.py``'s ``read(record)``."""
    spec = importlib.util.spec_from_file_location(
        f"h100_bench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cfg_json: dict, mix: traffic.Mix, limits: dict, seed: int,
             seconds: float, trace: bool, t_start: float,
             device: str = "cuda", control: bool = False,
             window_ticks: int | None = None) -> dict:
    """One run of a cell; returns the run's record, which the metrics
    read, with ``correct``, ``checks`` and the device's readings.
    ``control`` also reads the fp8 control's gaps on the same tokens;
    ``window_ticks`` is the CPU tests' window of that many ticks."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.sharding import NO_AXES
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.scheduler import Request
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg = model_config(cfg_json)
    params = make_weights(cfg, seed, device)
    engine = ServeEngine(cfg, RunConfig(remat="none", attn_impl="dense"),
                         params, NO_AXES, max_batch=mix.lanes,
                         max_seq=mix.max_seq, mem_arch=mix.mem_arch,
                         kv_mode="paged", page_len=mix.page_len,
                         device=device)
    day = traffic.make_day(mix, seed, cfg.vocab_size)
    requests = [Request(rid=i, arrival=int(day.arrival[i]),
                        prompt_len=int(day.prompt_len[i]),
                        max_new_tokens=int(day.max_new[i]),
                        tokens=day.tokens[i])
                for i in range(len(day.arrival))]
    sched_cls = scheduler_class()
    tracer = Tracer(sched_cls, engine, cuda) if trace else None
    sched = (tracer.sched_cls if tracer else sched_cls)(
        engine.kv_cfg, n_lanes=mix.lanes, max_seq=mix.max_seq,
        policy="seq-skew", n_kv_layers=engine.n_kv_layers,
        warm_ticks=mix.warm_ticks, seconds=seconds,
        window_ticks=window_ticks)
    if tracer is not None:
        sched.hook = tracer.hook(sched)
    gc.collect()
    gc.freeze()
    try:
        outputs = engine.run_scheduler(requests, scheduler=sched).outputs
    finally:
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    rec = _record(sched, t_start, day)
    rec.update(model=cfg_json["model"], lanes=mix.lanes, peak_bytes=peak,
               page_len=mix.page_len, trace=None, forbidden_modules=loaded)
    if tracer is not None:
        rec["trace"] = tracer.summary()
        rec["trace"]["rows_bytes"] = _rows_bytes(
            sched, engine.kv_cfg, *rec["trace"]["ticks"])
    engine.last_pools = None
    del engine
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    rec.update(_check(cfg_json["model"], params, sched, outputs, requests,
                      limits, seed, control))
    rec["check_s"] = time.perf_counter() - t_check
    rec["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name() if cuda else "cpu",
                     "count": 1, "memory_peak_bytes": int(peak)}
    if tracer is not None:
        rec["device"].update(busy_s=rec["trace"]["busy_s"],
                             window_s=rec["trace"]["window_s"])
    return rec


def _record(sched, t_start: float, day) -> dict:
    """What the metrics read: the window, every window tick, each generated
    token's gap and the requests that arrive in the window (a request
    arrives at the entry of the first tick at or after its arrival tick)."""
    o = sched.warm_ticks
    # the window's timeline without the hook's pauses (the traced run's
    # profiler stop): every stamp after a pause moves back by it
    shift = np.cumsum([p if k > o else 0.0
                       for k, p in enumerate(sched.pauses)])
    stamps = [t - s for t, s in zip(sched.stamps, shift)] + \
        [sched.t_close - (shift[-1] if len(shift) else 0.0)]
    ticks, itl, decode_tokens = [], [], 0
    last_tok: dict = {}
    for i in range(len(sched.stamps)):
        t1 = stamps[i + 1]
        for rid, _ in sched.admitted[i]:
            last_tok[rid] = t1
        rids = sched.rids[i]
        live = None if rids is None else rids[rids >= 0]
        if live is not None:
            for rid in live.tolist():
                if i >= o:
                    itl.append(t1 - last_tok[rid])
                last_tok[rid] = t1
        if i < o:
            continue
        decode_tokens += 0 if live is None else live.size
        ticks.append({
            "wall": t1 - stamps[i], "host": sched.host[i],
            "prefills": [plen for _, plen in sched.admitted[i]],
            "positions": (None if rids is None
                          else sched.pos[i][rids >= 0]),
            "held": sched.held[i], "pages": sched.pages[i]})
    nows = np.asarray(sched.nows)
    first = np.searchsorted(nows, day.arrival)
    arrived = int(((first >= o) & (first < len(sched.stamps))).sum())
    return {"setup_s": sched.t_open - t_start,
            "window_s": stamps[-1] - stamps[o],
            "ticks": ticks, "itl": itl,
            "decode_tokens": decode_tokens, "arrived": arrived}


def _pick(outputs: dict, requests: list, seed: int) -> list:
    """The finished requests the check replays: the one with the most
    served tokens (then the longest prompt), and others drawn from the
    seed until ``CHECK_TOKENS`` served tokens or ``CHECK_MAX_REQUESTS``."""
    served = [rid for rid in sorted(outputs) if len(outputs[rid])]
    if not served:
        return []
    longest = max(served, key=lambda r: (len(outputs[r]),
                                         requests[r].prompt_len, -r))
    picked, total = [longest], len(outputs[longest])
    rng = np.random.default_rng([seed % (1 << 64), 1])
    for rid in rng.permutation([r for r in served if r != longest]):
        if total >= CHECK_TOKENS or len(picked) >= CHECK_MAX_REQUESTS:
            break
        picked.append(int(rid))
        total += len(outputs[int(rid)])
    return picked


def _check(model: dict, params: dict, sched, outputs: dict, requests: list,
           limits: dict, seed: int, control: bool) -> dict:
    """Replay the picked requests through the reference; ``correct`` where
    the widest gap of a served token's reference logit below the
    reference's best is within the cell's limit and enough tokens were
    checked."""
    picked = _pick(outputs, requests, seed)
    device = params["embed"].device
    seqs, n_out, served = [], [], []
    for rid in picked:
        r, out = requests[rid], np.asarray(outputs[rid], np.int64)
        seqs.append(torch.as_tensor(np.concatenate(
            [np.asarray(r.tokens, np.int64), out[:-1]]), device=device))
        n_out.append(len(out))
        served.append(torch.as_tensor(out, device=device))
    checked = sum(n_out)
    worst, per_request = float("inf"), []
    if picked:
        ref = reference.logits(model, params, seqs, n_out)
        per_request = [float(reference.gaps(lg, tok).max())
                       for lg, tok in zip(ref, served)]
        worst = max(per_request)
    limit = limits["max_logit_gap"]
    checks = {"max_logit_gap": {"value": worst, "limit": limit},
              "checked_tokens": {"value": checked,
                                 "limit": limits["min_checked_tokens"]}}
    failed = sum(g > limit for g in per_request)
    out = {"correct": bool(picked) and failed == 0
           and checked >= limits["min_checked_tokens"],
           "failed": int(failed), "checked_requests": len(picked),
           "checks": checks}
    if control:
        ctrl = reference.logits(model, params, seqs, n_out, fp8=True)
        out["control_gap"] = max(float(reference.gaps(
            lg, c.argmax(1)).max()) for lg, c in zip(ref, ctrl))
        out["program_gaps"] = per_request
    return out


def metric_names(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metrics of the run's kind: its end-to-end metrics, or
    with ``--trace 1`` its per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def result_line(bench: dict, workload: str, rec: dict) -> dict:
    """The run's result: ``correct``, ``attempted``, ``failed``, the
    cell's metrics of the run's kind (per-layer where the run was
    traced), ``device``, the traced run's ``breakdown``, and last the
    numbers compared with their limits."""
    metrics = {}
    for m in metric_names(bench, workload, rec["trace"] is not None):
        value = load_metric(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": rec["correct"], "attempted": rec["arrived"],
            "failed": rec["failed"], "metrics": metrics,
            "device": rec["device"]}
    if rec["trace"] is not None:
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                             "idle_gaps": rec["trace"]["idle_gaps"]}
    line["checks"] = rec["checks"]
    return line


def main(args, t_start: float) -> int:
    bench = benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg_json = json.loads((ROOT / cfg_entry["file"]).read_text())
    rec = run_cell(cfg_json, traffic.load_mix(wl["traffic"]),
                   load_json("limits", f"{wl['name']}.json"), args.seed,
                   args.seconds, bool(args.trace), t_start)
    if rec["forbidden_modules"]:
        print(f"modules loaded when the window closed: "
              f"{rec['forbidden_modules']}", file=sys.stderr)
        return 3
    line = result_line(bench, wl["name"], rec)
    walls = [t["wall"] for t in rec["ticks"]]
    print(f"run: {len(walls)} window ticks of {rec['window_s']:.3f} s, "
          f"tick median {1e3 * float(np.median(walls)):.2f} ms, "
          f"{rec['arrived']} arrivals, {rec['decode_tokens']} decode tokens, "
          f"set-up {rec['setup_s']:.3f} s, {rec['checked_requests']} "
          f"requests checked in {rec['check_s']:.3f} s", file=sys.stderr)
    for name, c in rec["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
