"""Serving launcher: batched generation of ``--arch`` on the CUDA card (port
of ``repro.launch.serve``'s batch path).

The KV cache runs on the banked paged pool by default (``--kv-mode
paged``); ``--mem-arch`` picks the memory architecture the pool banks on,
and ``--cost`` prices the recorded serving AddressTrace on the paper's
memories with the cost engine.  Weights are random, drawn from ``--seed``.

  python -m repro_torch.launch.serve --arch llama3.2-1b --cost

``--smoke`` serves the reduced config; ``--device cpu`` runs on the host
(the tests do).  (``--schedule`` and ``--fault-bank`` of the reference
come with the scheduler and fault slices.)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import arch as _arch
from repro_torch.core.cost_engine import cost_many
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.cost and args.kv_mode != "paged":
        ap.error("--cost needs --kv-mode paged (dense mode records no "
                 "serving traces)")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rc = RunConfig(remat="none", attn_impl="dense")
    gen = torch.Generator(device=args.device).manual_seed(args.seed)
    params = init_tree(model_specs(cfg), gen, device=args.device)
    engine = ServeEngine(cfg, rc, params, max_batch=args.batch,
                         max_seq=args.prompt_len + args.new_tokens + 4,
                         mem_arch=args.mem_arch, kv_mode=args.kv_mode,
                         page_len=args.page_len, device=args.device)
    run_batch(args, engine, cfg)


if __name__ == "__main__":
    main()
