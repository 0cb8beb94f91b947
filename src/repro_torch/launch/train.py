"""Training launcher: ``--arch <id>`` trained on synthetic Markov-chain
data on the CUDA card (port of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch llama3.2-1b --steps 4
  python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 3 \
      --device cpu

Every config trains: dense, MoE (its aux loss in the total), SSM, hybrid,
and the audio and vision configs on ``SyntheticLM``'s frontend
embeddings.  The flags are the reference's.  ``--device cpu`` trains on
the host (the tests do); without it the run needs the card and fails
where there is none.  ``--mesh`` trains on ``make_current_mesh()`` over
every rank of the launch: under ``torchrun`` it joins the launch's
process group (NCCL on the card, gloo with ``--device cpu``), without it
a one-rank group.

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-1b --steps 4 --mesh

  python -m repro_torch.launch.train --arch falcon-mamba-7b --smoke \
      --steps 2 --device cpu
"""
from __future__ import annotations

import argparse
import logging

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.mesh import init_distributed
from repro_torch.runtime.elastic import make_current_mesh
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None) -> dict:
    """Train; prints and returns the trainer's result."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", action="store_true",
                    help="train on a mesh of every rank of the launch")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("train: no CUDA device; training runs on the card "
                         "(pass --device cpu to train on the host)")
    logging.basicConfig(level=logging.INFO)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rc = RunConfig(remat=args.remat, attn_impl="dense",
                   microbatches=args.microbatches, learning_rate=args.lr,
                   warmup_steps=max(args.steps // 10, 1))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     global_batch=args.global_batch, seed=0,
                     frontend_tokens=cfg.n_frontend_tokens
                     if cfg.frontend else 0, d_model=cfg.d_model)
    tc = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt,
                       ckpt_every=max(args.steps // 4, 1))
    started = args.mesh and not dist.is_initialized()
    if args.mesh:
        init_distributed(args.device)
    try:
        mesh = make_current_mesh() if args.mesh else None
        out = Trainer(cfg, rc, tc, ds, mesh=mesh, device=args.device).run()
        lead = not args.mesh or dist.get_rank() == 0
    finally:
        if started:
            dist.destroy_process_group()
    if lead:              # every rank's metrics are the whole batch's
        print("final:", out["final"])
    return out


if __name__ == "__main__":
    main()
