from repro_torch.kernels.conflict_popcount.ops import (
    conflict_popcount, conflict_popcount_plain, conflict_popcount_symbolic,
    conflict_popcount_trace, conflict_popcount_trace_blocks)
from repro_torch.kernels.conflict_popcount.ref import conflict_popcount_ref
from repro_torch.kernels.registry import Kernel, register


def _n_banks(arch, n_banks=None) -> int:
    if n_banks is not None:
        return n_banks
    if arch.is_banked:
        return arch.n_banks
    if arch.vb_write_banks:            # 4R-1W-VB write side arbitration
        return arch.vb_write_banks
    raise NotImplementedError(
        f"{arch.name} has no banks to count conflicts over; pass n_banks "
        f"explicitly")


register(Kernel(
    name="conflict_popcount",
    cuda=lambda arch, banks, n_banks=None: conflict_popcount(
        banks, _n_banks(arch, n_banks)),
    ref=lambda arch, banks, n_banks=None, **_: conflict_popcount_ref(
        banks, _n_banks(arch, n_banks)),
    trace=conflict_popcount_trace,
    blocks=conflict_popcount_trace_blocks,
    symbolic=conflict_popcount_symbolic,
    description="issue-controller conflict counting (one-hot popcount + max)",
))

__all__ = ["conflict_popcount", "conflict_popcount_plain"]
