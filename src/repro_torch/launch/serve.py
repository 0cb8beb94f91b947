"""Serving launcher: generation of ``--arch`` on the CUDA card (port of
``repro.launch.serve``).

The KV cache runs on the banked paged pool by default (``--kv-mode
paged``); ``--mem-arch`` picks the memory architecture the pool banks on,
and ``--cost`` prices the recorded serving AddressTrace on the paper's
memories with the cost engine.  Weights are random, drawn from ``--seed``.

  python -m repro_torch.launch.serve --arch llama3.2-1b --cost

``--schedule`` switches to continuous batching: a seeded multi-tenant day
(``--n-requests`` jobs, ``--arrival-rate`` per tick, ``--context-dist``
lengths) is driven lane-ragged through ``ServeEngine.run_scheduler`` with
the ``--policy`` preferred-bank allocation; ``--cost`` prices the recorded
scheduler trace the same way.

  python -m repro_torch.launch.serve --arch llama3.2-1b --schedule \
      --n-requests 8 --arrival-rate 1.5 --context-dist mixed --cost

``--fault-bank`` injects a bank-loss fault into the scheduled day: the
bank goes offline at ``--fault-tick``, its live pages move to surviving
banks through the paired row kernels, and the day finishes degraded; the
summary reports the fault counters and, with ``--cost``, prices the
recorded trace on the degraded ``!d`` variant of the memory next to the
healthy one.

  python -m repro_torch.launch.serve --arch llama3.2-1b --schedule \
      --n-requests 8 --fault-bank 1 --fault-tick 4 --cost

Every text family serves: dense, MoE (mixtral, phi3.5-moe), SSM
(falcon-mamba: no attention layer, so no KV pool and a 0-cycle KV trace)
and hybrid (jamba: Mamba and attention layers, MoE FFNs).  The audio and
vision configs are refused before any weight is made: the serving path
passes no frontend embeddings, and their models need them ahead of the
tokens (the reference's ``_embed`` asserts as much).

  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --cost

``--smoke`` serves the reduced config; ``--device cpu`` runs on the host
(the tests do):

  python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke \
      --device cpu --cost
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import arch as _arch
from repro_torch.core.cost_engine import cost_many
from repro_torch.launch.sharding import NO_AXES
from repro_torch.models import init_tree, model_specs
from repro_torch.serving.engine import ServeEngine

COST_MEMORIES = ("16B", "16B-offset", "8B", "4B", "4R-1W", "4R-2W")


def run_batch(args, engine, cfg):
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len))
    res = engine.generate(prompts, max_new_tokens=args.new_tokens)
    for b in range(args.batch):
        print(f"req{b}: {res.tokens[b].tolist()}")
    if args.cost:
        step = engine.step_trace()
        full = engine.serving_trace()
        print(f"\nserving KV traffic ({engine.n_kv_layers} KV layers, "
              f"page_len={args.page_len}): step {step.n_ops} ops, "
              f"generation {full.n_ops} ops")
        print(f"{'memory':<12}{'step_cyc':>9}{'total_cyc':>10}"
              f"{'total_us':>9}")
        archs = [_arch.get(n) for n in COST_MEMORIES]
        cs = cost_many(archs, step, device=engine.device)
        cf = engine.serving_cost(archs)
        for a, s, f in zip(archs, cs, cf):
            print(f"{a.name:<12}{s.total_cycles:>9}{f.total_cycles:>10}"
                  f"{f.time_us(a.fmax_mhz):>9.2f}")


def no_frontend_message(cfg) -> str:
    return (f"--arch {cfg.name}: the serving path passes no frontend "
            f"embeddings, and this model needs {cfg.n_frontend_tokens} "
            f"({cfg.frontend}) before its tokens; serve a text-only config")


def _cost_table(trace, extra_line: str, device):
    """The trace priced on the ``COST_MEMORIES`` in one ``cost_many`` pass
    on ``device``, printed as the reference CLI prints it."""
    print(extra_line)
    print(f"{'memory':<12}{'total_cyc':>10}{'total_us':>9}")
    archs = [_arch.get(n) for n in COST_MEMORIES]
    for a, c in zip(archs, cost_many(archs, trace, device=device)):
        print(f"{a.name:<12}{c.total_cycles:>10}"
              f"{c.time_us(a.fmax_mhz):>9.2f}")


def run_schedule(args, engine, cfg):
    from repro_torch.serving.scheduler import synthesize_requests
    reqs = synthesize_requests(
        args.n_requests, arrival_rate=args.arrival_rate,
        context_dist=args.context_dist, max_seq=engine.max_seq,
        seed=args.seed, vocab_size=cfg.vocab_size)
    plan = None
    if args.fault_bank is not None:
        from repro_torch.runtime import FaultEvent, FaultPlan
        plan = FaultPlan((FaultEvent(tick=args.fault_tick,
                                     kind="bank_offline",
                                     bank=args.fault_bank),))
    res = engine.run_scheduler(reqs, policy=args.policy, fault_plan=plan)
    for r in reqs:
        out = res.outputs[r.rid]
        print(f"req{r.rid} (t={r.arrival} prompt={r.prompt_len} "
              f"new={r.max_new_tokens}): {out.tolist()}")
    s = res.stats
    print(f"\n{res.ticks} ticks, {int(s['decode_ticks'])} decode steps, "
          f"lane occupancy {s['lane_occupancy']:.2f}, bank occupancy skew "
          f"mad={s['bank_mad']:.2f} max/min={s['bank_max_min_ratio']:.2f} "
          f"(policy={args.policy})")
    f = s["faults"]
    if f["degraded"]:
        print(f"faults: bank(s) {f['dead_banks']} lost at tick "
              f"{args.fault_tick}, {f['migrated_pages']} live pages "
              f"migrated; day finished degraded (every request completed)")
    if args.cost:
        trace = (engine.scheduler_stream()
                 .materialize())  # lint: allow-materialize — tiny CLI day
        _cost_table(trace, f"\nscheduler KV traffic ({engine.n_kv_layers} "
                           f"KV layers): {trace.n_ops} ops", engine.device)
        if f["degraded"]:
            deg = engine.mem_arch.degrade(tuple(f["dead_banks"]))
            c = cost_many([deg], trace, device=engine.device)[0]
            print(f"{deg.name:<12}{c.total_cycles:>10}"
                  f"{c.time_us(deg.fmax_mhz):>9.2f}  (degraded survivors)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced smoke config of --arch")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--mem-arch", default="16B",
                    help="memory architecture the paged-KV pool banks on "
                         "(any repro_torch.core.arch name, e.g. 16B-offset)")
    ap.add_argument("--kv-mode", choices=("paged", "dense"), default="paged")
    ap.add_argument("--page-len", type=int, default=8,
                    help="tokens per KV page")
    ap.add_argument("--cost", action="store_true",
                    help="price the recorded serving trace on the paper "
                         "memories (paged mode only)")
    ap.add_argument("--schedule", action="store_true",
                    help="continuous batching: schedule a synthesized "
                         "multi-tenant day instead of one fixed batch")
    ap.add_argument("--arrival-rate", type=float, default=1.0,
                    help="mean request arrivals per scheduler tick")
    ap.add_argument("--context-dist", default="mixed",
                    help="context-length distribution "
                         "(repro_torch.serving.scheduler.CONTEXT_DISTS)")
    ap.add_argument("--n-requests", type=int, default=8,
                    help="requests in the synthesized day (--schedule)")
    ap.add_argument("--policy", default="seq-skew",
                    help="preferred-bank allocation policy "
                         "(kvcache.ALLOC_POLICIES: paper | seq-skew)")
    ap.add_argument("--fault-bank", type=int, default=None,
                    help="inject a bank-offline fault into the scheduled "
                         "day: this pool bank dies at --fault-tick "
                         "(--schedule only)")
    ap.add_argument("--fault-tick", type=int, default=4,
                    help="scheduler tick the --fault-bank loss fires at")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.fault_bank is not None and not args.schedule:
        ap.error("--fault-bank needs --schedule (fault plans run on the "
                 "continuous-batching scheduler)")
    if args.cost and args.kv_mode != "paged":
        ap.error("--cost needs --kv-mode paged (dense mode records no "
                 "serving traces)")
    if args.schedule and args.kv_mode != "paged":
        ap.error("--schedule needs --kv-mode paged (continuous batching "
                 "lives on the banked page pool)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.frontend:
        ap.error(no_frontend_message(cfg))
    rc = RunConfig(remat="none", attn_impl="dense")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_tree(model_specs(cfg), gen, device=args.device)
    engine = ServeEngine(cfg, rc, params, NO_AXES, max_batch=args.batch,
                         max_seq=args.prompt_len + args.new_tokens + 4,
                         mem_arch=args.mem_arch, kv_mode=args.kv_mode,
                         page_len=args.page_len, device=args.device)
    if args.schedule:
        run_schedule(args, engine, cfg)
    else:
        run_batch(args, engine, cfg)


if __name__ == "__main__":
    main()
