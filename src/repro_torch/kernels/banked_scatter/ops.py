"""Banked row scatter: table[physical_row_of(idx[i])] = updates[i], in
place, on a bank-major table (the paged-KV write path).

``banked_scatter`` is the wrapper: for a CUDA table it launches the
hand-written kernels of ``csrc/banked_rows.cu`` (which replace the Pallas
``banked_scatter_kernel`` of ``src/repro/kernels/banked_scatter/kernel.py``;
the source says what bounds them and how the design answers that), for a
CPU table it runs ``banked_scatter_plain``.  There is no fallback from one
to the other.  ``banked_scatter_pair`` writes the same rows of two tables
of one shape (a layer's K and V pools) in the same launches.

Unlike the reference, which returns a new array (the Pallas call aliases
the table into its output), both versions update the table in place and
return it: the serving pools are the largest state of a step, and a copy
per append would move the whole pool.  Duplicate indices resolve
last-writer-wins in index order; rows no index names keep their contents.
A call of up to ``STAGED_MAX`` indices is one launch; a larger one is two
(the claim, then the copy), through a per-device workspace of int64 words
(``claim_words``) that every call leaves zero.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.arch import physical_row_of
from repro_torch.kernels.banked_gather.ops import (check_pair, check_rows,
                                                   chunk_bytes, map_arg,
                                                   require_cuda)
from repro_torch.kernels.banked_scatter.ref import last_writers
from repro_torch.kernels.cuda_lib import CudaEntry, EntryGroup

#: the most indices of a one-launch scatter (kStagedMax of
#: csrc/banked_rows.cu: its blocks hold them in shared memory)
STAGED_MAX = 256

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the C entries and their launch counts: the one-launch scatter of one
#: table and of two tables that share the indices, and the two launches of
#: a larger call (claim, then copy, on one or two tables);
#: ``SCATTERS.launches`` is the kernel's, their sum.  Every entry ends with
#: the row map's address (``map_arg``).
SCATTER = CudaEntry("banked_rows", "banked_scatter_launch",
                    [_P, _P, _P, _I64, _I64, _I64, _P])
SCATTER_PAIR = CudaEntry("banked_rows", "banked_scatter_pair_launch",
                         [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P])
CLAIM = CudaEntry("banked_rows", "banked_scatter_claim_launch",
                  [_P, _I64, _P, _P])
CLAIMED_COPY = CudaEntry("banked_rows", "banked_scatter_copy_launch",
                         [_I32, _P, _P, _P, _P, _P, _I64, _I64, _P, _P])
SCATTERS = EntryGroup(SCATTER, SCATTER_PAIR, CLAIM, CLAIMED_COPY)

_CLAIMS: dict[torch.device, torch.Tensor] = {}


def claim_words(device: torch.device, v_rows: int) -> torch.Tensor:
    """The claimed scatter's workspace on ``device``: at least ``v_rows``
    int64 words, zero before and after every call.  Calls on one device
    share it, so they must not run on two streams at once."""
    words = _CLAIMS.get(device)
    if words is None or words.numel() < v_rows:
        words = _CLAIMS[device] = torch.zeros(v_rows, dtype=torch.int64,
                                              device=device)
    return words


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


def _launch(tables: tuple, updates: tuple, idx: torch.Tensor, n_banks: int,
            mapping: str, shift: int) -> None:
    """The scatter's launches on one or two CUDA tables of one shape."""
    (v, d), n = tables[0].shape, idx.shape[0]
    row = d * tables[0].element_size()
    rmap = map_arg(v, n, n_banks, mapping, shift)
    ptrs = [t.data_ptr() for t in tables] + [u.data_ptr() for u in updates]
    if n <= STAGED_MAX:
        entry = SCATTER if len(tables) == 1 else SCATTER_PAIR
        entry(*ptrs, idx.data_ptr(), n, row, chunk_bytes(n, row), rmap)
        return
    claims = claim_words(tables[0].device, v).data_ptr()
    CLAIM(idx.data_ptr(), n, claims, rmap)
    t1, u1 = (ptrs[1], ptrs[3]) if len(tables) == 2 else (None, None)
    CLAIMED_COPY(len(tables), ptrs[0], t1, ptrs[len(tables)], u1,
                 idx.data_ptr(), n, row, claims, rmap)


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
    require_cuda(table_banked, idx)
    if idx.shape[0]:
        _launch((table_banked,), (updates,), idx, n_banks, mapping, shift)
    return table_banked


def banked_scatter_pair(k_table: torch.Tensor, v_table: torch.Tensor,
                        idx: torch.Tensor, k_updates: torch.Tensor,
                        v_updates: torch.Tensor, n_banks: int = 16,
                        mapping: str = "lsb", shift: int = 1
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """``banked_scatter`` of ``k_updates`` / ``v_updates`` into the same
    rows of two distinct bank-major tables of one shape and dtype (a
    layer's K and V pools), in place; returns both tables.  The launches
    of one call on CUDA tables, the plain version twice on CPU ones."""
    check_rows(k_table, idx, n_banks, mapping)
    check_pair(k_table, v_table)
    _check_updates(k_table, idx, k_updates)
    _check_updates(v_table, idx, v_updates)
    if k_table.numel() and k_table.data_ptr() == v_table.data_ptr():
        raise ValueError("the pair needs two distinct tables")
    if k_table.device.type == "cpu":
        return (banked_scatter_plain(k_table, idx, k_updates, n_banks,
                                     mapping, shift),
                banked_scatter_plain(v_table, idx, v_updates, n_banks,
                                     mapping, shift))
    require_cuda(k_table, idx)
    if idx.shape[0]:
        _launch((k_table, v_table), (k_updates, v_updates), idx, n_banks,
                mapping, shift)
    return k_table, v_table


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
