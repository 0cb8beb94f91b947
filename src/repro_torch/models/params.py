"""Parameter-spec trees (port of ``repro.models.params``): one declaration
drives random init from a ``torch.Generator`` and the conversion of the
reference's parameters (``from_jax``).

A tree is nested dicts of ``Leaf``s with the reference's structure and key
names, so a parameter path means the same tensor in both packages.  There
are no logical sharding axes: the port runs on one card until the mesh
slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class Leaf:
    shape: tuple
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0          # stddev multiplier for normal init


def fan_in_scale(fan_in: int) -> float:
    return 1.0 / np.sqrt(max(fan_in, 1))


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of a nested-dict tree (and trees of the
    same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    return [tree]


def stack_specs(specs, n: int):
    """Prefix every leaf with a stacked (superblock) dimension of size n."""
    return tree_map(lambda l: Leaf((n,) + l.shape, l.init, l.scale), specs)


def count_params(specs) -> int:
    return int(sum(int(np.prod(l.shape)) for l in leaves(specs)))


def init_tree(specs, generator: torch.Generator, dtype=torch.float32,
              device="cuda"):
    """Materialize random parameters on ``device``: N(0, scale²) leaves
    drawn in tree order from ``generator`` (a generator on that device).
    The numbers differ from the reference's JAX PRNG; parity tests convert
    the reference's parameters with ``from_jax`` instead."""
    def make(leaf: Leaf) -> torch.Tensor:
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=dtype, device=device)
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=dtype, device=device)
        x = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * leaf.scale).to(dtype)
    return tree_map(make, specs)


def from_jax(specs, params_np, device="cuda"):
    """The reference's parameter tree, as numpy arrays (``embed``,
    ``final_norm``, ``blocks/b{j}/...`` stacked over superblocks,
    ``lm_head`` when untied), as the port's tensors on ``device``.  Every
    leaf of ``specs`` must be present with its exact shape."""
    def convert(leaf: Leaf, arr) -> torch.Tensor:
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"parameter shape {a.shape} != spec "
                             f"{leaf.shape}")
        return torch.from_numpy(np.array(a)).to(device)   # a writable copy
    return tree_map(convert, specs, params_np)
