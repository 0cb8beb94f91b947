"""Oracle: plain row gather on the logical table."""
import torch


def banked_gather_ref(table_logical: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    return table_logical[idx]
