"""Oracle: ``repro_torch.core.conflicts`` (the paper-faithful simulator
path), which counts every lane of each op."""
import torch

from repro_torch.core.conflicts import bank_counts, max_conflicts


def conflict_popcount_ref(banks: torch.Tensor, n_banks: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    return bank_counts(banks, n_banks), max_conflicts(banks, n_banks)
