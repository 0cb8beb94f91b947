"""Banked paged-KV serving, end to end on the card (the counterpart of
``examples/paged_kv_serving.py``): a real decode loop whose KV cache lives
in the paper's banked memory.

What this shows, in order:

 1. a smoke-size LM served by ``ServeEngine`` in the default paged mode:
    every decode step's KV reads and writes go through the paired row
    kernels (``banked_gather_pair`` / ``banked_scatter_pair``) on
    bank-major page pools;
 2. paged decode gives the dense reference's greedy tokens;
 3. the page table and the arbiter-balanced bank occupancy afterwards;
 4. the per-step ``AddressTrace`` the engine recorded, priced under five
    paper memories with the model that reproduces Tables II/III;
 5. ``tune.search`` picking a memory architecture for this traffic.

The weights are the port's own, drawn from a seeded generator; the traces
and their prices do not depend on them.

Run:  PYTHONPATH=src python -m repro_torch.examples.paged_kv_serving [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import tune
from repro_torch.bench import serving_workload
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import arch
from repro_torch.launch.sharding import NO_AXES
from repro_torch.models import init_tree, model_specs
from repro_torch.serving import ServeEngine, bank_load_stats

#: the memories the recorded traffic is priced on
MEMORIES = ("16B", "16B-offset", "4B", "4R-1W", "4R-2W")


def main(argv=None) -> dict:
    """Serve, check and price; returns the tokens, the cycles a memory
    and the two tuner picks."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.paged_kv_serving",
        description="Banked paged-KV serving end to end.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs and the traffic is priced "
                         "(default: cuda)")
    device = ap.parse_args(argv).device
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("paged_kv_serving: no CUDA device; the example "
                         "serves on the card (pass --device cpu to run on "
                         "the host)")

    # -- 1. serve a smoke model on the banked paged pool --------------------
    cfg = get_smoke_config("llama3.2-1b")
    rc = RunConfig(remat="none", attn_impl="dense")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_tree(model_specs(cfg), gen, device=device)
    b, prompt, new = 4, 12, 8

    engine = ServeEngine(cfg, rc, params, NO_AXES, max_batch=b, max_seq=32,
                         mem_arch="16B", kv_mode="paged", page_len=8,
                         device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(b, prompt)).astype(np.int32)
    res = engine.generate(prompts, max_new_tokens=new)
    print(f"served {b} requests × {prompt}+{new} tokens on a "
          f"{engine.mem_arch.name} paged-KV pool "
          f"(page_len={engine.kv_cfg.page_len}, "
          f"{engine.kv_cfg.n_pages} pages, {engine.n_kv_layers} KV layers)")
    for i in range(b):
        print(f"  req{i}: {res.tokens[i].tolist()}")

    # -- 2. the dense reference produces the same tokens --------------------
    ref = ServeEngine(cfg, rc, params, NO_AXES, max_batch=b, max_seq=32,
                      kv_mode="dense", device=device)
    if not np.array_equal(ref.generate(prompts, max_new_tokens=new).tokens,
                          res.tokens):
        raise AssertionError("paged decode != dense reference")
    print("\npaged decode == dense reference (greedy tokens identical) ✓")

    # -- 3. allocator state: page table + bank balance ----------------------
    pages = engine.last_pages
    print("\npage table (logical pool page id per in-sequence page; "
          "-1 unmapped):")
    for i in range(b):
        print(f"  seq{i}: {pages.page_table[i].tolist()}")
    stats = bank_load_stats(pages)
    print(f"bank occupancy: {pages.bank_used.tolist()}  "
          f"(max/mean serialization = {float(stats['serialization']):.2f} — "
          f"1.0 is a perfectly banked allocation)")

    # -- 4. price the recorded serving traffic ------------------------------
    step = engine.step_trace()
    full = engine.serving_trace()
    print(f"\nlast decode step put {step.n_ops} ops "
          f"({step.n_instructions} kernel calls) on the KV pool; "
          f"the whole generation {full.n_ops} ops:")
    print(f"  {'memory':<12}{'step_cyc':>9}{'total_cyc':>10}{'total_us':>9}")
    cycles = {}
    for name in MEMORIES:
        a = arch.get(name)
        cs, cf = a.cost(step, device=device), a.cost(full, device=device)
        cycles[name] = (cs.total_cycles, cf.total_cycles)
        print(f"  {name:<12}{cs.total_cycles:>9}{cf.total_cycles:>10}"
              f"{cf.time_us(a.fmax_mhz):>9.2f}")

    # -- 5. let the autotuner pick the memory for this traffic --------------
    w = serving_workload(batch=b, prompt_len=prompt, decode_steps=new - 1,
                         page_len=8, n_kv_layers=engine.n_kv_layers,
                         device=device)
    best_t = tune.search(workload=w, device=device)[0]
    best_at = tune.search(workload=w, objective="area_time", capacity_kb=256,
                          device=device)[0]
    print(f"\ntune.search on this traffic: raw time picks {best_t.arch} "
          f"({best_t.time_us:.2f} us) — the paper's small-dataset regime;")
    print(f"area×time at a 256 KB KV cache picks {best_at.arch} — the Fig 9 "
          f"crossover that makes banked memories the serving choice.")
    print("\nbanked paged-KV serving verified end-to-end ✓")
    return {"tokens": res.tokens, "cycles": cycles,
            "n_ops": (step.n_ops, full.n_ops),
            "picks": (best_t.arch, best_at.arch)}


if __name__ == "__main__":
    main()
