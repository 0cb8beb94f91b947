"""Banked row gather: out[i] = table[physical_row_of(idx[i])] on a
bank-major table (the paged-KV read path).

``banked_gather`` is the wrapper: for a CUDA table it launches the
hand-written kernel of ``csrc/banked_rows.cu`` (which replaces the Pallas
``banked_gather_kernel`` of ``src/repro/kernels/banked_gather/kernel.py``;
the source says what bounds it and how the design answers that), for a CPU
table it runs ``banked_gather_plain``, the same function in plain PyTorch.
There is no fallback from one to the other.  ``banked_gather_pair`` gathers
the same rows from two tables of one shape (a layer's K and V pools) in one
launch.

The host side of the row map lives here too: ``row_map`` computes, once per
(rows, layout, index width), the constants the kernels' integer path needs
(shift and mask for power-of-two bank counts, a multiply-shift divisor for
the others), and ``index_bits`` picks the index width.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.arch import BankedLayout, physical_row_of
from repro_torch.kernels.cuda_lib import CudaEntry, EntryGroup

def physical_rows(v: int, n_banks: int, mapping: str,
                  device="cuda") -> torch.Tensor:
    """logical row -> physical (bank-major) row of a ``v``-row table, as
    an int64 permutation on ``device``."""
    return BankedLayout(n_banks, mapping).physical_rows(v, device)


def to_banked_layout(table: torch.Tensor, n_banks: int,
                     mapping: str = "lsb") -> torch.Tensor:
    """Host-side relayout: scatter logical rows into bank-major order."""
    return BankedLayout(n_banks, mapping).to_banked(table)


def from_banked_layout(table_banked: torch.Tensor, n_banks: int,
                       mapping: str = "lsb") -> torch.Tensor:
    return BankedLayout(n_banks, mapping).from_banked(table_banked)


#: map-name -> the kernel's MapKind code
MAP_CODES = {"lsb": 0, "offset": 1, "xor": 2, "fold": 3}

INT32_MAX = 2 ** 31 - 1

#: the row chunk of a small call (two 16-byte words a lane), and the call
#: size from which each warp takes a whole row (``chunk_bytes``); both
#: chosen on the card by the chunk sweep of chip_smoke.py's row_times
CHUNK_BYTES = 1024
WHOLE_ROWS_BYTES = 1 << 22

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong

#: the C entries and their launch counts: one table, and two tables that
#: share the indices; ``GATHERS.launches`` is the kernel's, their sum.
#: Every entry ends with the row map's address (``map_arg``).
GATHER = CudaEntry("banked_rows", "banked_gather_launch",
                   [_P, _P, _P, _I64, _I64, _I64, _P])
GATHER_PAIR = CudaEntry("banked_rows", "banked_gather_pair_launch",
                        [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P])
GATHERS = EntryGroup(GATHER, GATHER_PAIR)


class RowMap(ctypes.Structure):
    """``struct RowMap`` of csrc/banked_rows.cu, field for field: a
    bank-major table's row map as the kernels compute it, at index width
    ``index_bits``.  ``magic`` = ceil(2^magic_shift / n_banks) divides by
    a bank count that is not a power of two (``log2_banks`` = -1) on the
    32-bit path, where every dividend is below 2^31 and magic_shift = 31
    + ceil(log2 n_banks), so the quotient is exact."""
    _fields_ = [("v_rows", ctypes.c_ulonglong),
                ("rows_per_bank", ctypes.c_ulonglong),
                ("magic", ctypes.c_ulonglong), ("n_banks", ctypes.c_int),
                ("map", ctypes.c_int), ("shift", ctypes.c_int),
                ("log2_banks", ctypes.c_int), ("magic_shift", ctypes.c_int),
                ("index_bits", ctypes.c_int)]


def index_bits(v_rows: int, n: int) -> int:
    """The kernels' index width: 32 when the table's rows and the call's
    indices fit in int32 (every serving pool), else 64."""
    return 32 if v_rows <= INT32_MAX and n <= INT32_MAX else 64


@functools.lru_cache(maxsize=None)
def row_map(v_rows: int, n_banks: int, mapping: str, shift: int,
            bits: int) -> RowMap:
    """The kernels' row map of a (v_rows, D) table under a layout that
    ``check_rows`` accepted, built once (the cache keeps it alive while
    the kernels read it through its address)."""
    if n_banks & (n_banks - 1) == 0:
        log2, magic, magic_shift = n_banks.bit_length() - 1, 0, 0
    else:
        log2, magic_shift = -1, 31 + n_banks.bit_length()
        magic = -(-(1 << magic_shift) // n_banks)
    return RowMap(v_rows, v_rows // n_banks, magic, n_banks,
                  MAP_CODES[mapping], shift, log2, magic_shift, bits)


def map_arg(v_rows: int, n: int, n_banks: int, mapping: str,
            shift: int) -> int:
    """The address of the C entries' row map for a call of ``n`` indices
    into a table of ``v_rows`` rows."""
    return ctypes.addressof(row_map(v_rows, n_banks, mapping, shift,
                                    index_bits(v_rows, n)))


def chunk_bytes(n: int, row_bytes: int) -> int:
    """The bytes of a row one warp copies: the whole row in a call of
    WHOLE_ROWS_BYTES or more (or a row of CHUNK_BYTES or less), else
    CHUNK_BYTES, so that a small call spreads over more warps."""
    if n * row_bytes >= WHOLE_ROWS_BYTES or row_bytes <= CHUNK_BYTES:
        return row_bytes
    return CHUNK_BYTES


@functools.lru_cache(maxsize=None)
def _check_layout(n_banks: int, mapping: str) -> None:
    BankedLayout(n_banks, mapping)        # raises on a bad map / bank count


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
    _check_layout(n_banks, mapping)


def check_pair(first: torch.Tensor, second: torch.Tensor) -> None:
    """A pair entry's second table (or update set) is of the first's
    shape, dtype and device, and contiguous."""
    if second.shape != first.shape:
        raise ValueError(f"paired tensors {tuple(first.shape)} and "
                         f"{tuple(second.shape)} differ in shape")
    if second.dtype != first.dtype:
        raise TypeError(f"paired tensors {first.dtype} and {second.dtype}")
    if second.device != first.device:
        raise ValueError(f"paired tensors on {first.device} and "
                         f"{second.device}")
    if not second.is_contiguous():
        raise ValueError("the row kernels need contiguous tensors")


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
    (v, d), n = table_banked.shape, idx.shape[0]
    out = table_banked.new_empty((n, d))
    if n:
        row = d * table_banked.element_size()
        GATHER(table_banked.data_ptr(), out.data_ptr(), idx.data_ptr(), n,
               row, chunk_bytes(n, row),
               map_arg(v, n, n_banks, mapping, shift))
    return out


def banked_gather_pair(k_table: torch.Tensor, v_table: torch.Tensor,
                       idx: torch.Tensor, n_banks: int = 16,
                       mapping: str = "lsb",
                       shift: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """``banked_gather`` of the same rows from two bank-major tables of one
    shape and dtype (a layer's K and V pools): one launch on CUDA tables,
    the plain version twice on CPU ones."""
    check_rows(k_table, idx, n_banks, mapping)
    check_pair(k_table, v_table)
    if k_table.device.type == "cpu":
        return (banked_gather_plain(k_table, idx, n_banks, mapping, shift),
                banked_gather_plain(v_table, idx, n_banks, mapping, shift))
    require_cuda(k_table, idx)
    (v, d), n = k_table.shape, idx.shape[0]
    out = k_table.new_empty((2, n, d))
    if n:
        row = d * k_table.element_size()
        base = out.data_ptr()
        GATHER_PAIR(k_table.data_ptr(), v_table.data_ptr(), base,
                    base + n * row, idx.data_ptr(), n, row,
                    chunk_bytes(n, row),
                    map_arg(v, n, n_banks, mapping, shift))
    k_out, v_out = out.unbind(0)
    return k_out, v_out


def banked_gather_trace(arch, table, idx, mask=None, **_):
    """The gather's exact AddressTrace: lane j of op o requests logical row
    ``idx[16·o + j]``; one gather call is one load instruction.  ``mask``
    predicates lanes off (e.g. unmapped paged-KV pages)."""
    from repro_torch.kernels.registry import row_stream_trace
    return row_stream_trace(idx, kind="load", mask=mask)


def banked_gather_symbolic(arch, table, idx, mask=None, **_):
    """The gather's traffic for the symbolic conflict prover: an
    arithmetic-progression index stream proves in closed form (a
    unit-stride gather is conflict-free on any map), anything
    data-dependent is enumerated exactly (see
    ``repro_torch.analysis.symbolic.affine_from_indices``)."""
    from repro_torch.analysis.symbolic import (SymbolicTrace,
                                               affine_from_indices)
    fam = affine_from_indices(idx, "load", "gather rows", mask=mask)
    return SymbolicTrace(families=(fam,), meta={"kernel": "banked_gather"})


def banked_gather_trace_blocks(arch, table, idx, mask=None, block_ops=None,
                               **_):
    """Streaming counterpart of ``banked_gather_trace`` (bit-equal cost)."""
    from repro_torch.kernels.registry import row_stream_blocks
    yield from row_stream_blocks(idx, kind="load", mask=mask,
                                 block_ops=block_ops)
