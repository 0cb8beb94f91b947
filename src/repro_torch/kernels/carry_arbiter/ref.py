"""Oracle: 16 steps of the carry-chain arbiter of
``repro_torch.core.arbiter``."""
import torch

from repro_torch.core.arbiter import WORD_MASK, arbiter_step
from repro_torch.kernels.carry_arbiter.ops import MAX_CYCLES


def carry_arbiter_ref(requests: torch.Tensor) -> torch.Tensor:
    """(ops, B) words -> (ops, MAX_CYCLES, B) int64 grant schedule."""
    v = requests.to(torch.int64) & WORD_MASK
    grants = []
    for _ in range(MAX_CYCLES):
        v, grant = arbiter_step(v)
        grants.append(grant)
    return torch.stack(grants, dim=1)
