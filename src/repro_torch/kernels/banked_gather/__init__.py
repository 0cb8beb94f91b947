from repro_torch.kernels.banked_gather.ops import (banked_gather,
                                                   banked_gather_plain,
                                                   banked_gather_trace,
                                                   banked_gather_trace_blocks)
from repro_torch.kernels.banked_gather.ref import banked_gather_ref
from repro_torch.kernels.registry import Kernel, register


def _run(arch, table, idx, *, table_banked=False):
    """Gather logical rows ``idx`` from a logical table under ``arch``'s
    storage layout.  Multi-port memories replicate data (no swizzle): the
    same kernel runs with one bank, whose map is the identity.

    ``table_banked=True`` declares the table already stored bank-major (a
    persistent pool, e.g. the serving paged-KV pool) and skips the per-call
    relayout — the serving hot path."""
    lay = arch.layout
    if lay is None:
        return banked_gather(table, idx, 1, "lsb")
    if not table_banked:
        table = lay.to_banked(table)
    return banked_gather(table, idx, lay.n_banks, lay.mapping, shift=lay.shift)


register(Kernel(
    name="banked_gather",
    cuda=_run,
    ref=lambda arch, table, idx, **_: banked_gather_ref(table, idx),
    trace=banked_gather_trace,
    blocks=banked_gather_trace_blocks,
    description="bank-major row gather (paged KV read path)",
))

__all__ = ["banked_gather", "banked_gather_plain"]
