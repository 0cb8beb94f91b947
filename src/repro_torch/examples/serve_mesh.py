"""Serving on a mesh: the ``ServeEngine`` with ``ax`` on every rank of a
launch, held to the same engine on one device.

Each rank draws the smoke config's seeded weights, keeps its shards
(placed by ``ax.resolve``) and serves the whole batch: ``generate`` paged
and dense, then a scheduled day through ``run_scheduler``.  The page pools
stay whole on every rank, the weights are gathered a block at a time.
Rank 0 prints the tokens and whether they equal the one-device engine's
(float32 compute), and the run fails if they do not.

Run, 4 gloo ranks on the CPU (a (2, 2) data x model mesh):
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 -m repro_torch.examples.serve_mesh --device cpu
On N cards:
  PYTHONPATH=src torchrun --standalone --nproc-per-node N -m repro_torch.examples.serve_mesh
Without a launcher it serves on a one-rank mesh.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import init_distributed, mesh_shape
from repro_torch.launch.sharding import NO_AXES, make_axes, own_block
from repro_torch.models import init_tree, model_specs
from repro_torch.models.params import spec_tree, tree_map
from repro_torch.runtime.elastic import make_current_mesh
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.scheduler import synthesize_requests


def main(argv=None) -> dict:
    """Serve on the mesh and on one device; returns whether each run's
    tokens are equal."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.serve_mesh",
        description="ServeEngine on a mesh of every rank of the launch.")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve_mesh: no CUDA device (pass --device cpu)")
    started = not dist.is_initialized()
    init_distributed(args.device)
    try:
        return _serve(args)
    finally:
        if started:
            dist.destroy_process_group()


def _serve(args) -> dict:
    cfg = get_smoke_config(args.arch)
    rc = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
    device = "cuda" if args.device == "cuda" else "cpu"
    mesh = make_current_mesh()
    ax = make_axes(mesh, rc)
    gen = torch.Generator(device=device).manual_seed(0)
    whole = init_tree(model_specs(cfg), gen, device=device)
    shards = tree_map(lambda t, s: own_block(t, s, mesh), whole,
                      spec_tree(model_specs(cfg), ax.resolve))
    kw = dict(max_batch=args.batch, page_len=8, device=device,
              max_seq=4 * -(-(args.prompt_len + args.new_tokens + 4) // 4))
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len))
    same, out = {}, {}
    for kv_mode in ("paged", "dense"):
        got = [ServeEngine(cfg, rc, p, on, kv_mode=kv_mode, **kw).generate(
            prompts, max_new_tokens=args.new_tokens).tokens
            for p, on in ((shards, ax), (whole, NO_AXES))]
        same[kv_mode] = bool(np.array_equal(*got))
        out[kv_mode] = got[0]
    reqs = synthesize_requests(6, arrival_rate=1.5, context_dist="mixed",
                               max_seq=kw["max_seq"], seed=0,
                               vocab_size=cfg.vocab_size)
    days = [ServeEngine(cfg, rc, p, on, **kw).run_scheduler(reqs).outputs
            for p, on in ((shards, ax), (whole, NO_AXES))]
    same["scheduled"] = days[0].keys() == days[1].keys() and all(
        np.array_equal(days[0][k], days[1][k]) for k in days[0])
    if dist.get_rank() == 0:
        print(f"arch={cfg.name} mesh={mesh_shape(mesh)} "
              f"batch={args.batch} prompt={args.prompt_len} "
              f"new={args.new_tokens}")
        for kv_mode, toks in out.items():
            print(f"{kv_mode}: req0 {toks[0].tolist()}")
        print(f"scheduled day: {len(days[0])} requests, "
              f"{sum(len(v) for v in days[0].values())} tokens")
        print(f"equal to one device: {same}")
    if not all(same.values()):
        raise SystemExit(f"serve_mesh: the mesh engine differs from one "
                         f"device's: {same}")
    if dist.get_rank() == 0:
        print("serving on a mesh verified ✓")
    return {"same": same, "tokens": out}


if __name__ == "__main__":
    main()
