"""``input_specs()``: ``ShapeStruct`` stand-ins for every model input of
every (arch x shape) cell, placed on the mesh and never allocated (port of
``repro.launch.inputs``).

Token ids are int64, the index dtype the port's models take (the
reference's are int32); every other leaf has the reference's dtype.  A
struct's ``local_shape`` is the block one rank holds; for an inference
cell the dry run passes ``ax.for_batch(global_batch)``, so the tokens are
a rank's rows and a cache leaf its block as ``decode_step`` keeps it.
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.launch.sharding import Axes
from repro_torch.models import transformer as T
from repro_torch.models.params import Leaf, ShapeStruct, shape_tree


def _struct(ax: Axes, shape: tuple, axes: tuple, dtype) -> ShapeStruct:
    """One input leaf, placed by ``ax`` (unplaced without a mesh)."""
    return shape_tree(Leaf(shape, axes), dtype, ax.resolve, ax.mesh)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, ax: Axes,
                train: bool) -> dict:
    """Token (+ frontend) input structs for train/prefill."""
    b, s = shape.global_batch, shape.seq_len
    f = cfg.n_frontend_tokens if cfg.frontend else 0
    out = {"tokens": _struct(ax, (b, s - f), ("batch", None), torch.int64)}
    if f:
        out["frontend"] = _struct(ax, (b, f, cfg.d_model),
                                  ("batch", None, None), torch.float32)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, ax: Axes,
                 cache_dtype=torch.bfloat16) -> dict:
    """Decode-step inputs: one new token + KV/SSM cache of seq_len + pos."""
    b, s = shape.global_batch, shape.seq_len
    cache = shape_tree(T.cache_specs(cfg, b, s), cache_dtype, ax.resolve,
                       ax.mesh)
    return {"token": _struct(ax, (b, 1), ("batch", None), torch.int64),
            "cache": _fp32_state(cache),
            "pos": _struct(ax, (), (), torch.int32)}


def _fp32_state(cache: dict) -> dict:
    """An SSM block's ``h`` state stays float32 (a recurrent
    accumulator); every other leaf keeps its dtype."""
    def fix(name, leaf):
        if name == "h":
            return ShapeStruct(leaf.shape, torch.float32, leaf.spec,
                               leaf.local_shape)
        return leaf
    return {"blocks": {key: {name: fix(name, leaf)
                             for name, leaf in block.items()}
                       for key, block in cache["blocks"].items()}}


def input_specs(arch: str, shape: ShapeConfig, ax: Axes,
                rc: RunConfig) -> dict:
    cfg = get_config(arch)
    if shape.kind in ("train", "prefill"):
        return batch_specs(cfg, shape, ax, train=shape.kind == "train")
    return decode_specs(cfg, shape, ax)

