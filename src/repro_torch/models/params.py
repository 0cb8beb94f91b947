"""Parameter-spec trees (port of ``repro.models.params``): one declaration
drives random init from a ``torch.Generator``, the conversion of the
reference's parameters (``from_jax``) and sharding resolution.

A tree is nested dicts of ``Leaf``s with the reference's structure and key
names, so a parameter path means the same tensor in both packages.  Each
leaf carries the reference's *logical* axis names; ``spec_tree`` resolves
them to mesh axes (``repro_torch.launch.sharding.Axes.resolve``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


@dataclass(frozen=True)
class Leaf:
    shape: tuple
    axes: tuple                 # logical axis name (str) or None per dim
    init: str = "normal"        # normal | zeros | ones
    scale: float = 1.0          # stddev multiplier for normal init

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"Leaf shape {self.shape} and axes "
                             f"{self.axes} differ in length")


def fan_in_scale(fan_in: int) -> float:
    return 1.0 / np.sqrt(max(fan_in, 1))


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of a tree of nested dicts and named
    tuples (``TrainState``, ``OptState``), and trees of the same
    structure in ``rest``; a ``None`` subtree of ``tree`` stays ``None``.
    Plain tuples are leaves (a resolved sharding spec is one)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    return None if tree is None else fn(tree, *rest)


def is_leaf(x) -> bool:
    return isinstance(x, Leaf)


def tree_map_leaves(fn: Callable, specs):
    """Map ``fn`` over the ``Leaf``s of a spec tree (``TrainState`` and
    ``OptState`` included)."""
    return tree_map(fn, specs)


def spec_tree(specs, resolver):
    """The tree of resolved placements: ``resolver(leaf.axes,
    leaf.shape)`` for every leaf (``Axes.resolve``'s per-dimension
    entries)."""
    return tree_map_leaves(lambda l: resolver(l.axes, l.shape), specs)


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    return [tree]


def stack_specs(specs, n: int, axis_name: str = "layers"):
    """Prefix every leaf with a stacked (superblock) dimension of size n."""
    return tree_map(
        lambda l: Leaf((n,) + l.shape, (axis_name,) + l.axes, l.init,
                       l.scale), specs)


def count_params(specs) -> int:
    return int(sum(int(np.prod(l.shape)) for l in leaves(specs)))


def init_tree(specs, generator: torch.Generator, dtype=torch.float32,
              device="cuda", place=None):
    """Materialize random parameters on ``device``: N(0, scale²) leaves
    drawn in tree order from ``generator`` (a generator on that device).
    The numbers differ from the reference's JAX PRNG; parity tests convert
    the reference's parameters with ``from_jax`` instead.  ``place``, a
    tree of callables of ``specs``'s structure, maps each leaf to what is
    kept of it as soon as it is drawn (a mesh rank's block), so no more
    than one whole leaf exists at a time; the draws are the same."""
    def make(leaf: Leaf, keep=None) -> torch.Tensor:
        if leaf.init == "zeros":
            x = torch.zeros(leaf.shape, dtype=dtype, device=device)
        elif leaf.init == "ones":
            x = torch.ones(leaf.shape, dtype=dtype, device=device)
        else:
            x = torch.randn(leaf.shape, generator=generator,
                            dtype=torch.float32, device=device)
            x = (x * leaf.scale).to(dtype)
        return x if keep is None else keep(x)
    return tree_map(make, specs) if place is None else \
        tree_map(make, specs, place)


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
