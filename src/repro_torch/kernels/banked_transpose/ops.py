"""Tiled matrix transpose — the data path of the paper's Table II workload.

``banked_transpose`` is the wrapper: for a CUDA tensor it launches the
hand-written kernel of ``csrc/banked_transpose.cu`` (which replaces the
Pallas ``banked_transpose_kernel`` of
``src/repro/kernels/banked_transpose/kernel.py``; the source says what
bounds it and how its padded shared-memory tile answers the bank
conflicts), for a CPU tensor it runs ``banked_transpose_ref``, the same
function in plain PyTorch.  There is no fallback from one to the other.
The trace generators give the Table II program's exact request stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.banked_transpose.ref import banked_transpose_ref
from repro_torch.kernels.cuda_lib import CudaEntry

#: the reference kernel's tile edge; shapes must be multiples of
#: min(TILE, N, M), the reference's rule
TILE = 128
#: the CUDA kernel's tile edge (its grid's second axis counts row tiles)
CUDA_TILE = 32
MAX_GRID_Y = 65535

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the C entry and its launch count (``TRANSPOSE.launches``)
TRANSPOSE = CudaEntry("banked_transpose", "banked_transpose_launch",
                      [_P, _P, _I64, _I64, _I32])


def check_transpose(x: torch.Tensor) -> None:
    """The reference's shape rule (N and M multiples of T = min(TILE, N, M))
    plus what the kernel takes: a contiguous 2-D tensor of 2- or 4-byte
    elements.  Checked on either path, so a CPU run refuses what the card
    would."""
    if x.dim() != 2:
        raise ValueError(f"need an (N, M) matrix, got {tuple(x.shape)}")
    n, m = x.shape
    t = min(TILE, n, m)
    if t <= 0 or n % t or m % t:
        raise ValueError(f"shape {(n, m)} is not a whole number of "
                         f"{t}x{t} tiles")
    if x.element_size() not in (2, 4) or x.is_complex():
        raise TypeError(f"the transpose kernel takes 2- or 4-byte elements, "
                        f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the transpose kernel needs a contiguous tensor")
    if -(-n // CUDA_TILE) > MAX_GRID_Y:
        raise ValueError(f"{n} rows exceed the kernel's grid")


def banked_transpose(x: torch.Tensor) -> torch.Tensor:
    """(N, M) -> (M, N), a new contiguous tensor: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU one."""
    check_transpose(x)
    if x.device.type == "cpu":
        return banked_transpose_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs a CUDA tensor, got "
                         f"{x.device}")
    n, m = x.shape
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    TRANSPOSE(x.data_ptr(), out.data_ptr(), n, m, x.element_size())
    return out


def _transpose_n(x) -> int:
    n, m = x.shape
    if n != m or n < 16 or n & (n - 1):
        raise NotImplementedError(
            f"transpose trace model needs square power-of-two N>=16, got "
            f"{(n, m)}")
    return n


def banked_transpose_trace(arch, x, **_):
    """Exact AddressTrace of the paper's N×N transpose benchmark (the Table
    II workload): the per-lane load/store address streams of the SIMT
    program, not a row-stream proxy.  Needs a square power-of-two N ≥ 16."""
    n = _transpose_n(x)
    from repro_torch.core.trace import AddressTrace
    from repro_torch.isa.programs.transpose import transpose_program
    return AddressTrace.from_program(transpose_program(n))


def banked_transpose_symbolic(arch, x, **_):
    """The Table II transpose traffic as closed-form lane families for the
    symbolic conflict prover (the SIMT program's own ``symbolic_trace``:
    the proved ``TraceCost`` equals ``cost_many`` on
    ``banked_transpose_trace``)."""
    from repro_torch.isa.programs.transpose import symbolic_trace
    return symbolic_trace(_transpose_n(x))


def banked_transpose_trace_blocks(arch, x, block_ops=None, **_):
    """Streaming counterpart of ``banked_transpose_trace``: the Table II
    program stream emitted block-by-block from the lazy macro-op iterator,
    in O(block) memory and bit-equal in cost to the dense path."""
    n = _transpose_n(x)
    from repro_torch.isa.programs.transpose import (iter_transpose_instrs,
                                                    transpose_n_threads)
    from repro_torch.isa.vm import instr_trace_blocks
    yield from instr_trace_blocks(iter_transpose_instrs(n),
                                  n_threads=transpose_n_threads(n),
                                  block_ops=block_ops)
