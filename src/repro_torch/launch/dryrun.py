"""Dry run: trace every (architecture x input shape) cell's step on the
production mesh without a process group or an allocation, and record what
it computes, moves and keeps (port of ``repro.launch.dryrun``).

The step is the port's own (``train.step.make_train_step``,
``models.transformer.prefill`` / ``decode_step``), run on fake tensors of
``--device`` under ``torch._subclasses.fake_tensor.FakeTensorMode``: each
rank's shards of the inputs, on a stand-in of the 256- or 512-card mesh
(``launch/mesh.py``'s ``StandInMesh``), whose collectives are dry.  Every
dispatched op is counted (``launch/hlo_analysis.py``: FLOPs, bytes, live
bytes, collective bytes by kind).  On a mesh the train step gathers its
weights whole before the forward; the inference step gathers them one
superblock at a time and keeps its cache where the reference keeps it
(``models/transformer.py``).

Eager tracing visits every superblock, where XLA's cost analysis counts
a scan body once, so one trace counts the whole step: it is recorded as
``full``, and ``block`` is empty, so that ``roofline.adjusted(art, k)``
(``full`` + (``block_multiplier`` - 1) x ``block``, the reference's scan
adjustment) is the whole step's count.  ``launch/blocks.py`` keeps the
reference's one-superblock functions.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out DIR]

Artifacts go to ``build/dryrun`` unless ``--out`` names another place.
Fake CUDA tensors need a torch built with CUDA (not a card); elsewhere
pass ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import (ARCH_IDS, SHAPES, all_cells, get_config,
                                 shapes_for)
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.inputs import batch_specs, decode_specs
from repro_torch.launch.mesh import chips, production_stand_in
from repro_torch.launch.sharding import make_axes
from repro_torch.models import transformer as T
from repro_torch.models.params import ShapeStruct, shape_tree, tree_map
from repro_torch.train.step import make_train_step, train_state_specs

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")


def _default_rc(kind: str, overrides: dict | None = None) -> RunConfig:
    rc = RunConfig() if kind == "train" else \
        RunConfig(param_dtype="bfloat16", zero1=False)
    if overrides:
        rc = dataclasses.replace(rc, **overrides)
    return rc


def materialize(tree, device):
    """Tensors of each ``ShapeStruct``'s local shape and dtype on
    ``device`` (fake ones under ``FakeTensorMode``); dicts, tuples and
    named tuples keep their structure."""
    if isinstance(tree, ShapeStruct):
        return torch.empty(tree.local_shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        parts = [materialize(v, device) for v in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") else \
            tuple(parts)
    return tree


def cell_inputs(cfg, rc: RunConfig, shape: ShapeConfig, ax):
    """(the step, its argument structs) of one cell on ``ax``'s mesh."""
    pspecs = T.model_specs(cfg)
    pdt = getattr(torch, rc.param_dtype)
    if shape.kind == "train":
        state = shape_tree(train_state_specs(cfg, rc), pdt, ax.resolve,
                           ax.mesh)
        # optimizer moments are always fp32
        state = state._replace(
            step=ShapeStruct((), torch.int32, state.step.spec, ()),
            opt=tree_map(lambda l: dataclasses.replace(
                l, dtype=torch.float32), state.opt))
        step = make_train_step(cfg, rc, ax=ax)
        return step, (state, batch_specs(cfg, shape, ax, train=True))
    ax = ax.for_batch(shape.global_batch)
    params = shape_tree(pspecs, pdt, ax.resolve, ax.mesh)
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape, ax, train=False)

        def prefill(p, tokens, frontend=None):
            return T.prefill(cfg, rc, p, tokens, frontend, ax=ax)
        return prefill, (params, batch["tokens"]) + (
            (batch["frontend"],) if "frontend" in batch else ())
    d = decode_specs(cfg, shape, ax)

    def decode(p, token, cache, pos):
        return T.decode_step(cfg, rc, p, token, cache, pos, ax=ax)
    return decode, (params, d["token"], d["cache"], d["pos"])


def lower_cell(arch: str, shape: ShapeConfig, multi_pod: bool,
               rc_overrides: dict | None = None, verbose: bool = True,
               mesh=None, cfg=None, device: str = "cuda") -> dict:
    """One cell's record: the whole step's counts, memory and collectives
    (traced on fake ``device`` tensors) as ``full``, and the trace
    times."""
    cfg = cfg or get_config(arch)
    rc = _default_rc(shape.kind, rc_overrides)
    mesh = mesh if mesh is not None else \
        production_stand_in(multi_pod=multi_pod)
    ax = make_axes(mesh, rc)
    # the reference's scan multiplier, kept for its readers: with an empty
    # ``block`` it adds nothing
    block_mult = cfg.n_superblocks * (rc.microbatches
                                      if shape.kind == "train" else 1)
    res = {"arch": arch, "shape": shape.name, "seq_len": shape.seq_len,
           "global_batch": shape.global_batch,
           "mesh": "multi" if multi_pod else "single",
           "chips": chips(mesh), "kind": shape.kind, "device": device,
           "n_superblocks": cfg.n_superblocks,
           "block_multiplier": block_mult,
           "pattern_len": len(cfg.block_pattern()),
           "rc": {k: getattr(rc, k) for k in
                  ("remat", "attn_impl", "moe_impl", "seq_parallel",
                   "microbatches", "param_dtype", "zero1", "fsdp_axis")}}

    with FakeTensorMode():
        t0 = time.perf_counter()
        step, args = cell_inputs(cfg, rc, shape, ax)
        args = materialize(args, device)
        res["lower_s"] = round(time.perf_counter() - t0, 3)

        t0 = time.perf_counter()
        whole = analyze(step, *args)[1]
        res["compile_s"] = round(time.perf_counter() - t0, 3)
        del args
    res["full"], res["block"] = whole, {}

    if verbose:
        mem = whole["memory"]
        print(f"[{arch} × {shape.name} × {res['mesh']}] "
              f"trace {res['compile_s']}s  "
              f"flops/dev {whole['flops']:.3e}  "
              f"args {mem['argument_bytes']/2**30:.2f} GiB  "
              f"temp {mem['temp_bytes']/2**30:.2f} GiB  "
              f"coll {whole['collectives']['total']/2**20:.1f} MiB")
        print("  memory:", mem)
        print("  counted: flops=%.4e bytes=%.4e ops=%d" %
              (whole["flops"], whole["bytes_accessed"], whole["ops"]))
    return res


def artifact_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--rc", default="", help="json RunConfig overrides")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of the fake tensors (nothing is "
                         "allocated on it)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("name a cell (--arch and --shape) or pass --all")
    if args.device == "cuda" and not torch.backends.cuda.is_built():
        ap.error("this torch is built without CUDA, so it makes no fake "
                 "CUDA tensors; pass --device cpu")

    os.makedirs(args.out, exist_ok=True)
    overrides = json.loads(args.rc) if args.rc else None
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = all_cells() if args.all else \
        [(args.arch, SHAPES[args.shape])]

    failures = 0
    for arch, shape in cells:
        if shape not in shapes_for(arch):
            continue
        for mp in meshes:
            mname = "multi" if mp else "single"
            path = artifact_path(args.out, arch, shape.name, mname)
            if args.skip_existing and os.path.exists(path):
                print(f"skip {path}")
                continue
            try:
                res = lower_cell(arch, shape, mp, overrides,
                                 device=args.device)
            except Exception:
                failures += 1
                res = {"arch": arch, "shape": shape.name, "mesh": mname,
                       "error": traceback.format_exc()}
                print(f"FAILED {arch} × {shape.name} × {mname}")
                print(res["error"])
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
    if failures:
        raise SystemExit(f"{failures} cells failed")
    print("dry-run complete")


if __name__ == "__main__":
    main()
