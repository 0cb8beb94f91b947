"""Bank-conflict counting — the read/write issue controllers' math (paper
§III.A; port of ``repro.core.conflicts``).

A memory *operation* is one clock's worth of 16 lane requests.  The
controller turns each lane's bank index into a one-hot row of a
(lanes × banks) matrix, counts each column, and the **maximum count is the
number of clock cycles the operation needs**.  Same-address requests are
not broadcast.  Every function is vectorized over leading op axes.
"""
from __future__ import annotations

import torch


def bank_onehot(banks: torch.Tensor, n_banks: int) -> torch.Tensor:
    """(..., lanes) bank ids -> (..., lanes, n_banks) one-hot int32."""
    cols = torch.arange(n_banks, dtype=banks.dtype, device=banks.device)
    return (banks[..., None] == cols).to(torch.int32)


def bank_counts(banks: torch.Tensor, n_banks: int,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Per-bank population counts: (..., lanes) -> (..., n_banks) int32.
    ``mask`` (same shape as banks, nonzero = lane active) predicates lanes."""
    onehot = bank_onehot(banks, n_banks)
    if mask is not None:
        onehot = onehot * mask[..., None].to(torch.int32)
    return onehot.sum(dim=-2, dtype=torch.int32)


def max_conflicts(banks: torch.Tensor, n_banks: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Cycles each operation needs = max per-bank count: (..., lanes) -> (...)."""
    return bank_counts(banks, n_banks, mask).amax(dim=-1)


def first_occurrence(addrs: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., lanes) -> (..., lanes) int32, 1 where the lane's address is the
    first occurrence within the operation (broadcast coalescing mask).
    Predicated-off lanes (``mask`` false) are never a first occurrence and
    never shadow a later lane."""
    eq = addrs[..., :, None] == addrs[..., None, :]        # (..., L, L)
    lanes = addrs.shape[-1]
    lower = torch.ones((lanes, lanes), dtype=torch.bool,
                       device=addrs.device).tril(diagonal=-1)
    if mask is not None:
        active = mask.to(torch.bool)
        eq = eq & active[..., None, :]
    first = ~(eq & lower).any(dim=-1)
    if mask is not None:
        first = first & active
    return first.to(torch.int32)


def max_conflicts_broadcast(addrs: torch.Tensor, banks: torch.Tensor,
                            n_banks: int,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Beyond-paper broadcast memory: cycles = max per-bank count of
    DISTINCT addresses among the active lanes."""
    return max_conflicts(banks, n_banks, mask=first_occurrence(addrs, mask))
