"""Carry-chain arbiter (paper §III.C, Figs 5-6; port of
``repro.core.arbiter``).

Per bank, a lane-request word ``v`` (bit l set = lane l wants this bank)
grants one lane per cycle, lowest lane first:

    w      = v - 1          # borrow ripples up the carry chain
    grant  = v & ~w         # the single 1 -> 0 transition  (== v & -v)
    v'     = v & w          # clear it

The reference keeps request words in uint32, which torch supports for few
operations.  Here they are int64 tensors holding the same 32-bit pattern:
every result is masked with ``WORD_MASK`` so the values are exactly the
uint32 words (``v - 1`` of 0 wraps to 0xFFFFFFFF, as in uint32).
"""
from __future__ import annotations

import torch

from repro_torch.core.conflicts import bank_onehot

WORD_MASK = 0xFFFFFFFF


def arbiter_step(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One arbitration cycle. v: (...,) int64 request words (32-bit values).
    Returns (v_next, grant); grant is the lowest set bit of v (0 if none)."""
    w = (v - 1) & WORD_MASK
    grant = v & ~w & WORD_MASK
    return v & w, grant


def pack_requests(onehot_lanes: torch.Tensor) -> torch.Tensor:
    """(..., lanes) 0/1 -> packed request word (lane 0 = LSB), int64."""
    lanes = onehot_lanes.shape[-1]
    if lanes > 32:
        raise ValueError("arbiter supports up to 32 lanes")
    weights = torch.ones(lanes, dtype=torch.int64,
                         device=onehot_lanes.device) << torch.arange(
                             lanes, device=onehot_lanes.device)
    return (onehot_lanes.to(torch.int64) * weights).sum(dim=-1)


def unpack_grants(grants: torch.Tensor, lanes: int) -> torch.Tensor:
    """packed grant words (...,) -> (..., lanes) one-hot int32."""
    shifts = torch.arange(lanes, device=grants.device)
    return ((grants[..., None] >> shifts) & 1).to(torch.int32)


def arbitrate_schedule(banks: torch.Tensor, n_banks: int,
                       lanes: int | None = None,
                       max_cycles: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full arbitration of one operation.

    banks: (lanes,) bank index per lane.  Returns ``schedule`` (max_cycles,
    n_banks, lanes) one-hot grants — cycle c, bank b serves lane l iff
    schedule[c, b, l] == 1 — and ``cycles`` () = max per-bank popcount."""
    lanes = lanes if lanes is not None else banks.shape[-1]
    max_cycles = max_cycles if max_cycles is not None else lanes
    per_bank = bank_onehot(banks, n_banks).T           # (banks, lanes)
    v = pack_requests(per_bank)
    grants = []
    for _ in range(max_cycles):
        v, grant = arbiter_step(v)
        grants.append(grant)
    schedule = unpack_grants(torch.stack(grants), lanes)
    return schedule, per_bank.sum(dim=-1).amax()


def output_mux_controls(schedule: torch.Tensor,
                        mem_latency: int = 3) -> torch.Tensor:
    """Input mux controls delayed by the bank RAM latency and transposed
    become the output (writeback) mux controls:
    (cycles, banks, lanes) -> (cycles + latency, lanes, banks)."""
    _, banks, lanes = schedule.shape
    delayed = torch.cat([schedule.new_zeros((mem_latency, banks, lanes)),
                         schedule])
    return delayed.transpose(-1, -2)


def grant_positions(banks: torch.Tensor, n_banks: int,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Analytic form of the grant schedule: the cycle on which each lane is
    served = its rank among lower-indexed lanes requesting the same bank.
    (..., lanes) -> (..., lanes) int32 (exclusive prefix count)."""
    onehot = bank_onehot(banks, n_banks)
    if mask is not None:
        onehot = onehot * mask[..., None].to(torch.int32)
    cum = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
    return (cum * onehot).sum(dim=-1, dtype=torch.int32)
