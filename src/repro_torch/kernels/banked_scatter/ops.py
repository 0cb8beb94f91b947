"""Banked row scatter: table[physical_row_of(idx[i])] = updates[i], in
place, on a bank-major table (the paged-KV write path).

``banked_scatter`` is the wrapper: for a CUDA table it launches the
hand-written kernel of ``csrc/banked_rows.cu`` (which replaces the Pallas
``banked_scatter_kernel`` of ``src/repro/kernels/banked_scatter/kernel.py``;
the source says what bounds it and how the design answers that), for a CPU
table it runs ``banked_scatter_plain``.  There is no fallback from one to
the other.

Unlike the reference, which returns a new array (the Pallas call aliases
the table into its output), both versions update the table in place and
return it: the serving pools are the largest state of a step, and a copy
per append would move the whole pool.  Duplicate indices resolve
last-writer-wins in index order; rows no index names keep their contents.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.arch import physical_row_of
from repro_torch.kernels.banked_gather.ops import (check_rows, kernel_args,
                                                   require_cuda)
from repro_torch.kernels.banked_scatter.ref import last_writers
from repro_torch.kernels.cuda_lib import CudaEntry

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the C entry and its launch count (``SCATTER.launches``)
SCATTER = CudaEntry("banked_rows", "banked_scatter_launch",
                    [_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, _I32,
                     _I32])


def _check_updates(table: torch.Tensor, idx: torch.Tensor,
                   updates: torch.Tensor) -> None:
    if updates.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(f"updates {tuple(updates.shape)} do not match "
                         f"({idx.shape[0]}, {table.shape[1]})")
    if updates.dtype != table.dtype:
        raise TypeError(f"updates {updates.dtype} vs table {table.dtype}")
    if updates.device != table.device:
        raise ValueError(f"updates on {updates.device}, table on "
                         f"{table.device}")
    if not updates.is_contiguous():
        raise ValueError("the row kernels need contiguous tensors")


def banked_scatter_plain(table_banked: torch.Tensor, idx: torch.Tensor,
                         updates: torch.Tensor, n_banks: int = 16,
                         mapping: str = "lsb",
                         shift: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an index-ordered
    ``index_copy_`` of the last writer of each physical row."""
    v = table_banked.shape[0]
    phys = physical_row_of(idx, n_banks, v // n_banks, mapping, shift)
    keep = last_writers(phys, v)
    return table_banked.index_copy_(0, phys[keep], updates[keep])


def banked_scatter(table_banked: torch.Tensor, idx: torch.Tensor,
                   updates: torch.Tensor, n_banks: int = 16,
                   mapping: str = "lsb", shift: int = 1) -> torch.Tensor:
    """Write ``updates[i]`` into logical row ``idx[i]`` (int64) of a
    bank-major (V, D) table, in place; returns the table.  The CUDA kernel
    on a CUDA table, the plain version on a CPU one."""
    check_rows(table_banked, idx, n_banks, mapping)
    _check_updates(table_banked, idx, updates)
    if table_banked.device.type == "cpu":
        return banked_scatter_plain(table_banked, idx, updates, n_banks,
                                    mapping, shift)
    require_cuda(table_banked, idx, updates)
    if idx.shape[0]:
        SCATTER(table_banked.data_ptr(), idx.data_ptr(), updates.data_ptr(),
                idx.shape[0], *kernel_args(table_banked, n_banks, mapping,
                                           shift))
    return table_banked


def banked_scatter_trace(arch, table, idx, updates=None, mask=None, **_):
    """The scatter's exact AddressTrace: the row-index stream as one store
    instruction.  ``mask`` predicates lanes off."""
    from repro_torch.kernels.registry import row_stream_trace
    return row_stream_trace(idx, kind="store", mask=mask)


def banked_scatter_trace_blocks(arch, table, idx, updates=None, mask=None,
                                block_ops=None, **_):
    """Streaming counterpart of ``banked_scatter_trace`` (bit-equal cost)."""
    from repro_torch.kernels.registry import row_stream_blocks
    yield from row_stream_blocks(idx, kind="store", mask=mask,
                                 block_ops=block_ops)
