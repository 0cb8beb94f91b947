"""Arbitration -> partitioned-resource dispatch bridge (port of
``repro.core.dispatch``).

The paper's controller/arbiter math, applied ahead of time:

  requests  = tokens asking for a bank (= MoE expert / table shard / KV page)
  popcount  = per-bank load  (paper: conflict count)
  position  = grant cycle    (paper: carry-chain grant order; here the
                              exclusive cumsum, which tests/test_arbiter.py
                              proves identical)
  capacity  = the cycles the schedule budget allows; requests granted a
              position >= capacity are dropped (the FPGA would stall
              instead; a GPU kernel cannot, so the budget becomes a
              capacity factor).

``banked_dispatch`` is the primitive the MoE layer and the banked
embedding gather build on.  Every function runs on the device of the
tensors it is given and keeps static shapes, as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.arbiter import grant_positions
from repro_torch.core.conflicts import bank_counts


@dataclass(frozen=True)
class DispatchPlan:
    """Static-shape dispatch of R requests onto B banks with capacity C.

    All tensors have the requests axis first (flattened token×k order — the
    paper's lane order, which fixes grant priority).
    """
    bank: torch.Tensor           # (R,) int32 — target bank per request
    position: torch.Tensor       # (R,) int32 — grant slot within the bank
    kept: torch.Tensor           # (R,) bool  — granted within capacity
    bank_load: torch.Tensor      # (B,) int32 — per-bank popcount
    max_conflicts: torch.Tensor  # ()   int32 — the paper's cycles for the op

    @property
    def capacity(self) -> int:
        return self._capacity  # type: ignore[attr-defined]


def banked_dispatch(bank: torch.Tensor, n_banks: int, capacity: int,
                    mask: torch.Tensor | None = None) -> DispatchPlan:
    """Arbitrate a flat request vector onto banks.

    bank: (R,) bank id per request; mask: (R,) optional validity.
    """
    bank = bank.to(torch.int32)
    pos = grant_positions(bank, n_banks, mask)          # (R,)
    load = bank_counts(bank, n_banks, mask)             # (B,)
    valid = (torch.ones_like(bank, dtype=torch.bool) if mask is None
             else mask.to(torch.bool))
    kept = valid & (pos < capacity)
    plan = DispatchPlan(bank=bank, position=pos, kept=kept, bank_load=load,
                        max_conflicts=load.amax())
    object.__setattr__(plan, "_capacity", capacity)
    return plan


def scatter_to_banks(values: torch.Tensor, plan: DispatchPlan, n_banks: int,
                     capacity: int) -> torch.Tensor:
    """Place request payloads into a (B, C, ...) banked buffer (dropped
    requests land nowhere; their slots stay zero)."""
    feat = tuple(values.shape[1:])
    b = torch.where(plan.kept, plan.bank, n_banks)      # the drop row
    p = torch.where(plan.kept, plan.position, 0)
    buf = values.new_zeros((n_banks + 1, capacity) + feat)
    # the reference's ``.at[b, p].set(mode="drop")``: negative indices count
    # from the end, indices out of range write nothing
    inside = ((b >= -(n_banks + 1)) & (b <= n_banks) & (p >= -capacity)
              & (p < capacity))
    buf[b[inside], p[inside]] = values[inside]
    return buf[:n_banks]


def _clamped(idx: torch.Tensor, size: int) -> torch.Tensor:
    """A gather index as JAX reads it: negative counts from the end, then
    clamped into [0, size)."""
    return torch.where(idx < 0, idx + size, idx).clamp(0, size - 1)


def gather_from_banks(buf: torch.Tensor, plan: DispatchPlan
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Read each request's slot back out of a (B, C, ...) banked buffer.

    Returns (values, kept_mask); dropped requests read zeros.
    """
    vals = buf[_clamped(plan.bank, buf.shape[0]),
               _clamped(plan.position, buf.shape[1])]
    keep = plan.kept.reshape(plan.kept.shape + (1,) * (vals.dim() - 1))
    return vals * keep.to(vals.dtype), plan.kept


def serialization_factor(plan: DispatchPlan) -> torch.Tensor:
    """Paper bank-efficiency inverse: max-load / mean-load (>= 1)."""
    load = plan.bank_load.to(torch.float32)
    return load.amax() / load.mean().clamp(min=1e-9)
