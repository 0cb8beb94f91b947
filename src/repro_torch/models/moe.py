"""Mixture-of-experts sizing (port of the part of ``repro.models.moe``
that whole-model decode traffic needs).

``capacity`` is the per-expert slot budget of one dispatch group: the
arbiter's grant positions at or above it are dropped, as the reference's
GShard-style layer drops them.  The router, the expert FFN and the MoE
layer itself are model code and come with ROADMAP item 21.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def capacity(cfg: ModelConfig, group_len: int) -> int:
    """Slots per expert for a group of ``group_len`` tokens: the capacity
    factor times the group's ``experts_per_token`` requests spread over
    ``n_experts``, rounded up to a multiple of 4, at least 4."""
    c = cfg.capacity_factor * cfg.experts_per_token * group_len / cfg.n_experts
    return max(4, -(-int(c) // 4) * 4)
