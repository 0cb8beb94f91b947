"""Banked row gather: out[i] = table[physical_row_of(idx[i])] on a
bank-major table (the paged-KV read path).

``banked_gather`` is the wrapper: for a CUDA table it launches the
hand-written kernel of ``csrc/banked_rows.cu`` (which replaces the Pallas
``banked_gather_kernel`` of ``src/repro/kernels/banked_gather/kernel.py``;
the source says what bounds it and how the design answers that), for a CPU
table it runs ``banked_gather_plain``, the same function in plain PyTorch.
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.arch import BankedLayout, physical_row_of
from repro_torch.kernels.cuda_lib import CudaEntry

D_TILE = 512

#: map-name -> the kernel's MapKind code
MAP_CODES = {"lsb": 0, "offset": 1, "xor": 2, "fold": 3}

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the C entry and its launch count (``GATHER.launches``)
GATHER = CudaEntry("banked_rows", "banked_gather_launch",
                   [_P, _P, _P, _I64, _I64, _I64, _I64, _I32, _I32, _I32,
                    _I32])


def row_tile(d: int) -> int:
    """Row-tile width in elements: D_TILE when it divides the row, else the
    whole row as one tile (narrow rows such as page lines)."""
    return D_TILE if d % D_TILE == 0 else d


def check_rows(table: torch.Tensor, idx: torch.Tensor, n_banks: int,
               mapping: str) -> None:
    """The checks both row kernels share (shape, dtype, device, layout,
    contiguity), on either path, so a CPU run catches what the kernel
    would refuse."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"need a (V, D) table and (N,) indices, got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"indices must be int64, got {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"indices on {idx.device}, table on {table.device}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("the row kernels need contiguous tensors")
    if table.shape[0] % n_banks:
        raise ValueError(f"{table.shape[0]} rows not divisible by "
                         f"{n_banks} banks")
    BankedLayout(n_banks, mapping)        # validates the map / bank count


def kernel_args(table: torch.Tensor, n_banks: int, mapping: str,
                shift: int) -> tuple:
    """(v_rows, row_bytes, tile_bytes, n_banks, map, shift, log2_banks)."""
    v, d = table.shape
    elt = table.element_size()
    return (v, d * elt, row_tile(d) * elt, n_banks, MAP_CODES[mapping],
            shift, n_banks.bit_length() - 1)


def require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                             f"{t.device}")


def banked_gather_plain(table_banked: torch.Tensor, idx: torch.Tensor,
                        n_banks: int = 16, mapping: str = "lsb",
                        shift: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``table[physical rows]``."""
    v = table_banked.shape[0]
    return table_banked[physical_row_of(idx, n_banks, v // n_banks, mapping,
                                        shift)]


def banked_gather(table_banked: torch.Tensor, idx: torch.Tensor,
                  n_banks: int = 16, mapping: str = "lsb",
                  shift: int = 1) -> torch.Tensor:
    """Gather logical rows ``idx`` (int64) from a bank-major (V, D) table:
    the CUDA kernel on a CUDA table, the plain version on a CPU one."""
    check_rows(table_banked, idx, n_banks, mapping)
    if table_banked.device.type == "cpu":
        return banked_gather_plain(table_banked, idx, n_banks, mapping, shift)
    require_cuda(table_banked, idx)
    out = torch.empty((idx.shape[0], table_banked.shape[1]),
                      dtype=table_banked.dtype, device=table_banked.device)
    if idx.shape[0]:
        GATHER(table_banked.data_ptr(), idx.data_ptr(), out.data_ptr(),
               idx.shape[0], *kernel_args(table_banked, n_banks, mapping,
                                          shift))
    return out


def banked_gather_trace(arch, table, idx, mask=None, **_):
    """The gather's exact AddressTrace: lane j of op o requests logical row
    ``idx[16·o + j]``; one gather call is one load instruction.  ``mask``
    predicates lanes off (e.g. unmapped paged-KV pages)."""
    from repro_torch.kernels.registry import row_stream_trace
    return row_stream_trace(idx, kind="load", mask=mask)


def banked_gather_trace_blocks(arch, table, idx, mask=None, block_ops=None,
                               **_):
    """Streaming counterpart of ``banked_gather_trace`` (bit-equal cost)."""
    from repro_torch.kernels.registry import row_stream_blocks
    yield from row_stream_blocks(idx, kind="load", mask=mask,
                                 block_ops=block_ops)
