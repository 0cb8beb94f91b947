"""Conflict popcount — the issue controllers' math (paper §III.A): each
operation's lane bank ids counted per bank, and the max count (the cycles
the operation needs).

``conflict_popcount`` is the wrapper: for a CUDA tensor it launches the
hand-written kernel of ``csrc/controllers.cu`` (which replaces the Pallas
``conflict_popcount_kernel`` of
``src/repro/kernels/conflict_popcount/kernel.py``; the source says what
bounds it and how the design answers that), for a CPU tensor it runs
``conflict_popcount_plain``, the same function in plain PyTorch.  There is
no fallback from one to the other.  The trace generators give the bank-id
matrix as its request stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.memsim import LANES
from repro_torch.kernels.banked_gather.ops import require_cuda
from repro_torch.kernels.cuda_lib import CudaEntry
from repro_torch.kernels.registry import host_array

#: the reference kernel's block of operations: n_ops must be a multiple of
#: it (with 16 lanes) or smaller than it
OP_BLOCK = 256

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the C entry and its launch count (``POPCOUNT.launches``)
POPCOUNT = CudaEntry("controllers", "conflict_popcount_launch",
                     [_P, _P, _P, _I64, _I32, _I32, _I32])


def check_popcount(banks: torch.Tensor, n_banks: int) -> None:
    """The reference's shape rule, ``(lanes == 16 and n_ops % 256 == 0) or
    n_ops < 256`` on an (n_ops, lanes) matrix with n_ops, lanes and n_banks
    at least 1 (the reference raises on zero sizes too).  Checked on either
    path, so a CPU run refuses what the card would."""
    if banks.dim() != 2:
        raise ValueError(f"need an (n_ops, lanes) matrix, got "
                         f"{tuple(banks.shape)}")
    n_ops, lanes = banks.shape
    if n_ops < 1 or lanes < 1 or n_banks < 1:
        raise ValueError(f"need n_ops, lanes and n_banks >= 1, got "
                         f"{(n_ops, lanes)} and {n_banks} banks")
    if not (lanes == LANES and n_ops % OP_BLOCK == 0 or n_ops < OP_BLOCK):
        raise ValueError(f"shape {(n_ops, lanes)}: n_ops must be below "
                         f"{OP_BLOCK}, or a multiple of it with {LANES} "
                         f"lanes")


def conflict_popcount_plain(banks: torch.Tensor, n_banks: int = 16
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the first min(lanes, 16) ids
    of each op (as int32, as the reference casts them) added into n_banks
    counters; ids outside [0, n_banks) count nowhere."""
    ids = banks[:, :LANES].to(torch.int32).to(torch.int64)
    valid = (ids >= 0) & (ids < n_banks)
    counts = torch.zeros((banks.shape[0], n_banks), dtype=torch.int32,
                         device=banks.device)
    counts.scatter_add_(1, torch.where(valid, ids, 0), valid.to(torch.int32))
    return counts, counts.amax(dim=1)


def conflict_popcount(banks: torch.Tensor, n_banks: int = 16
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ops, 16) lane bank ids -> ((ops, B) int32 counts, (ops,) int32 max
    cycles): the CUDA kernel on a CUDA tensor, the plain version on a CPU
    one."""
    check_popcount(banks, n_banks)
    if banks.device.type == "cpu":
        return conflict_popcount_plain(banks, n_banks)
    require_cuda(banks)
    ids = banks.to(torch.int32).contiguous()
    n_ops, lanes = ids.shape
    counts = torch.empty((n_ops, n_banks), dtype=torch.int32,
                         device=ids.device)
    cycles = torch.empty(n_ops, dtype=torch.int32, device=ids.device)
    POPCOUNT(ids.data_ptr(), counts.data_ptr(), cycles.data_ptr(), n_ops,
             lanes, min(lanes, LANES), n_banks)
    return counts, cycles


def conflict_popcount_trace(arch, banks, n_banks=None, **_):
    """The (ops, 16) lane bank-id matrix as an AddressTrace: bank ids double
    as word addresses (id < n_banks, so the LSB map is the identity), making
    ``arch.cost`` reproduce the controller's own max-popcount cycles."""
    from repro_torch.core.trace import AddressTrace
    return AddressTrace.from_ops(host_array(banks), kind="load")


def conflict_popcount_symbolic(arch, banks, n_banks=None, **_):
    """The controller's bank-id matrix for the symbolic conflict prover
    (bank ids double as word addresses, as in ``conflict_popcount_trace``):
    an exact ``DataFamily`` enumeration."""
    from repro_torch.analysis.symbolic import DataFamily, SymbolicTrace
    from repro_torch.core.trace import as_ops
    fam = DataFamily(name="lane bank ids", kind="load",
                     addrs=as_ops(host_array(banks)))
    return SymbolicTrace(families=(fam,),
                         meta={"kernel": "conflict_popcount"})


def conflict_popcount_trace_blocks(arch, banks, n_banks=None, block_ops=None,
                                   **_):
    """Streaming counterpart of ``conflict_popcount_trace``: the bank-id
    matrix chunked to at-most-``block_ops``-op blocks of the same one load
    instruction (bit-equal costing)."""
    from repro_torch.core.trace import iter_op_chunks
    yield from iter_op_chunks(host_array(banks), kind="load",
                              block_ops=block_ops)
