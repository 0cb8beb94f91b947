"""End-to-end training example (the counterpart of
``examples/train_lm.py``): train an LM on the synthetic Markov-chain corpus
with the full trainer (AdamW + WSD, remat, checkpointing, preemption
guard, watchdog), on the card unless ``--device cpu`` is given.

Presets:
  tiny  (default) — ~3M-param llama-family model, 200 steps; the loss
                    drops visibly toward the chain entropy.
  100m            — ~100M-param model, sized for the card.

``--arch <id> --smoke`` trains that architecture's reduced config, any of
the ten: dense, MoE, SSM, hybrid, and the audio and vision configs, whose
frontend embeddings ``SyntheticLM`` makes.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--preset tiny]
          [--arch llama3.2-1b --smoke] [--steps 200] [--ckpt DIR]
          [--device cpu]
"""
from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import Trainer, TrainerConfig

PRESETS = {
    "tiny": ModelConfig(name="tiny-llama", family="dense", n_layers=4,
                        d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                        vocab_size=512, tie_embeddings=True),
    "100m": ModelConfig(name="lm-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                        vocab_size=32768, tie_embeddings=True),
}


def main(argv=None) -> dict:
    """Train and print the loss history; raises if the loss did not
    fall.  Returns the trainer's result."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's reduced smoke config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.arch and not args.smoke:
        ap.error("--arch trains the arch's reduced config: add --smoke")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train_lm: no CUDA device; the example trains on "
                         "the card (pass --device cpu to train on the host)")
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = get_smoke_config(args.arch) if args.arch else PRESETS[args.preset]

    rc = RunConfig(remat="none", attn_impl="dense", learning_rate=args.lr,
                   warmup_steps=20)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.batch, seed=7, branching=4,
                     frontend_tokens=cfg.n_frontend_tokens
                     if cfg.frontend else 0,
                     d_model=cfg.d_model)
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                       ckpt_every=max(args.steps // 4, 1), log_every=10)
    out = Trainer(cfg, rc, tc, ds, device=args.device).run()

    hist = out["history"]
    print("\nstep  loss")
    for h in hist:
        print(f"{h['step']:5d}  {h['loss']:.4f}")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    chain_entropy = np.log(ds.branching)
    print(f"\nloss {first:.3f} -> {last:.3f} "
          f"(uniform ln V = {np.log(cfg.vocab_size):.2f}, "
          f"chain entropy floor ≈ {chain_entropy:.2f})")
    if not last < first:
        raise AssertionError("training did not reduce loss")
    return out


if __name__ == "__main__":
    main()
