"""Oracle: ``grant_positions`` from ``repro_torch.core.arbiter`` (the
dispatch bridge)."""
import torch

from repro_torch.core.arbiter import grant_positions


def moe_dispatch_ref(experts: torch.Tensor, n_experts: int, capacity: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    pos = grant_positions(experts, n_experts)
    return pos, pos < capacity
