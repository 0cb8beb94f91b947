from repro_torch.kernels.banked_scatter.ops import (
    banked_scatter, banked_scatter_pair, banked_scatter_plain,
    banked_scatter_symbolic, banked_scatter_trace,
    banked_scatter_trace_blocks)
from repro_torch.kernels.banked_scatter.ref import banked_scatter_ref
from repro_torch.kernels.registry import Kernel, register


def _run(arch, table, idx, updates, *, table_banked=False):
    """Scatter ``updates`` into logical rows ``idx`` of a logical table;
    returns the updated table in logical order (a new tensor).  Multi-port
    memories replicate data (no swizzle): the same kernel runs with one
    bank, whose map is the identity.

    ``table_banked=True`` declares the table already stored bank-major (a
    persistent pool, e.g. the serving paged-KV pool): the relayout is
    skipped on both sides and the table is updated in place."""
    lay = arch.layout
    if lay is None:
        return banked_scatter(table if table_banked else table.clone(), idx,
                              updates, 1, "lsb")
    if table_banked:
        return banked_scatter(table, idx, updates, lay.n_banks, lay.mapping,
                              shift=lay.shift)
    out = banked_scatter(lay.to_banked(table), idx, updates, lay.n_banks,
                         lay.mapping, shift=lay.shift)
    return lay.from_banked(out)


register(Kernel(
    name="banked_scatter",
    cuda=_run,
    ref=lambda arch, table, idx, updates, **_: banked_scatter_ref(
        table, idx, updates),
    trace=banked_scatter_trace,
    blocks=banked_scatter_trace_blocks,
    symbolic=banked_scatter_symbolic,
    description="bank-major row scatter (paged KV write path)",
))

__all__ = ["banked_scatter", "banked_scatter_pair",
           "banked_scatter_plain"]
