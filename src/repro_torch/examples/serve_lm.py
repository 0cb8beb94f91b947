"""Batched serving example (the counterpart of ``examples/serve_lm.py``):
prefill and decode a batch of requests through the ``ServeEngine``'s
banked paged-KV decode path, on the smoke config of ``--arch`` (any text
family: dense, MoE, SSM or hybrid) with the port's seeded weights.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch llama3.2-1b] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.serve import no_frontend_message
from repro_torch.launch.sharding import NO_AXES
from repro_torch.models import init_tree, model_specs
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> dict:
    """Generate twice (greedy decoding must repeat itself); returns the
    prompts and the tokens."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_lm",
        description="Batched prefill + decode through the ServeEngine.")
    ap.add_argument("--arch", default="llama3.2-1b",
                    help=f"model config (one of {', '.join(ARCH_IDS)})")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)
    if args.arch not in ARCH_IDS:
        ap.error(f"--arch {args.arch}: unknown model config; choose from "
                 f"{', '.join(ARCH_IDS)}")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_lm: no CUDA device; the example serves on "
                         "the card (pass --device cpu to run on the host)")

    cfg = get_smoke_config(args.arch)
    if cfg.frontend:
        ap.error(no_frontend_message(cfg))
    rc = RunConfig(remat="none", attn_impl="dense")
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = init_tree(model_specs(cfg), gen, device=args.device)
    engine = ServeEngine(cfg, rc, params, NO_AXES, max_batch=args.batch,
                         max_seq=args.prompt_len + args.new_tokens + 4,
                         device=args.device)

    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)).astype(np.int32)
    res = engine.generate(prompts, max_new_tokens=args.new_tokens,
                          temperature=args.temperature)
    print(f"arch={cfg.name}  batch={args.batch}  "
          f"prompt={args.prompt_len}  generated={res.steps} tokens/request")
    for b in range(args.batch):
        print(f"  req{b}: prompt={prompts[b].tolist()[:8]}... "
              f"-> {res.tokens[b].tolist()}")
    # decode determinism check (greedy)
    res2 = engine.generate(prompts, max_new_tokens=args.new_tokens)
    if args.temperature <= 0 and not np.array_equal(res.tokens, res2.tokens):
        raise AssertionError("greedy decode is not deterministic")
    print("greedy decode deterministic ✓")
    return {"prompts": prompts, "tokens": res.tokens, "again": res2.tokens}


if __name__ == "__main__":
    main()
