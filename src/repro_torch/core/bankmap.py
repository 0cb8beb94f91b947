"""Bank mapping strategies: word address -> bank index (port of
``repro.core.bankmap``).

The paper (III.B.2) uses two maps:
  * ``lsb``    — bank = addr mod B                         (the default)
  * ``offset`` — bank = (addr >> shift) mod B              (the "Offset" map)

and the beyond-paper bit-mixing maps:
  * ``xor``    — bank = (addr ^ (addr >> log2(B))) & (B-1)
  * ``fold``   — bank = (addr + (addr >> log2(B))) & (B-1)

Every map is plain integer operators, so it applies unchanged to torch
tensors (any integer dtype; the result keeps it), numpy arrays and Python
ints.  ``lsb`` and ``offset`` take any bank count (``% B`` for non-pow2
counts, the ``& (B-1)`` mask otherwise — equal on non-negative addresses);
``xor`` and ``fold`` stay power-of-two only.
"""
from __future__ import annotations

import functools
from typing import Callable

BANK_MAPS = ("lsb", "offset", "xor", "fold")


def _log2(n: int) -> int:
    if n & (n - 1) or n <= 0:
        raise ValueError(f"bank count must be a power of two, got {n}")
    return n.bit_length() - 1


def _check_banks(n: int) -> None:
    if n <= 0:
        raise ValueError(f"bank count must be positive, got {n}")


def lsb_map(addr, n_banks: int):
    """bank = addr mod B (the lower log2(B) bits when B is a power of two)."""
    _check_banks(n_banks)
    if n_banks & (n_banks - 1) == 0:
        return addr & (n_banks - 1)
    return addr % n_banks


def offset_map(addr, n_banks: int, shift: int = 2):
    """The paper's Offset map: ``(addr >> shift) mod B``."""
    _check_banks(n_banks)
    if n_banks & (n_banks - 1) == 0:
        return (addr >> shift) & (n_banks - 1)
    return (addr >> shift) % n_banks


def xor_map(addr, n_banks: int):
    """XOR-folded interleave (beyond-paper)."""
    b = _log2(n_banks)
    return (addr ^ (addr >> b)) & (n_banks - 1)


def fold_map(addr, n_banks: int):
    """Additive diagonal skew (beyond-paper)."""
    b = _log2(n_banks)
    return (addr + (addr >> b)) & (n_banks - 1)


_TABLE = {"lsb": lsb_map, "offset": offset_map, "xor": xor_map,
          "fold": fold_map}


def get_bank_map(name: str, **kwargs) -> Callable:
    """Resolve a bank map by name. kwargs are bound (e.g. shift for offset)."""
    if name not in _TABLE:
        raise ValueError(f"unknown bank map {name!r}; choose from {BANK_MAPS}")
    fn = _TABLE[name]
    if kwargs:
        fn = functools.partial(fn, **kwargs)
    return fn


def bank_of(addr, n_banks: int, mapping: str = "lsb", **kwargs):
    """Convenience: apply a named bank map."""
    return get_bank_map(mapping, **kwargs)(addr, n_banks)
