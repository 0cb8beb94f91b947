"""Carry-chain arbiter (paper §III.C, Fig 5): per bank, one requesting lane
granted per cycle, lowest first — 16 cycles of ``grant = v & ~(v - 1)``,
``v &= v - 1`` over (ops × banks) request words.

``carry_arbiter`` is the wrapper: for a CUDA tensor it launches the
hand-written kernel of ``csrc/controllers.cu`` (which replaces the Pallas
``carry_arbiter_kernel`` of ``src/repro/kernels/carry_arbiter/kernel.py``;
the source says what bounds it and how the design answers that), for a
CPU tensor it runs ``carry_arbiter_plain``, the same function in plain
PyTorch.  There is no fallback from one to the other.

The reference's words are uint32.  The port carries them as int64 tensors
holding the 32-bit pattern (``repro_torch.core.arbiter``); the kernel reads
int32 and int64 words as they are (the low 32 bits count) and writes the
int64 grants itself (zero-extended), so a call on either is one launch
and its result equals the reference's words bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.arbiter import WORD_MASK
from repro_torch.core.memsim import LANES
from repro_torch.kernels.banked_gather.ops import require_cuda
from repro_torch.kernels.cuda_lib import CudaEntry
from repro_torch.kernels.registry import host_array

#: the reference kernel's block of operations: n_ops must be a multiple of
#: min(OP_BLOCK, n_ops)
OP_BLOCK = 128
#: grant cycles per word (the lanes of one operation)
MAX_CYCLES = 16

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the C entry and its launch count (``ARBITER.launches``)
ARBITER = CudaEntry("controllers", "carry_arbiter_launch",
                    [_P, _I32, _P, _I32, _I64, _I32])
#: the widest request row the kernel takes (its 32 KB chunks of a row stay
#: within the grid's second dimension)
MAX_BANKS = 1 << 23
#: request dtypes the kernel reads as they are: 4- and 8-byte words
KERNEL_DTYPES = (torch.int32, torch.int64)


def check_arbiter(requests: torch.Tensor) -> None:
    """The reference's shape rule, ``n_ops % min(128, n_ops) == 0``, on an
    (n_ops, B) matrix with n_ops and B at least 1 (the reference raises on
    zero sizes too).  Checked on either path."""
    if requests.dim() != 2:
        raise ValueError(f"need an (n_ops, banks) matrix, got "
                         f"{tuple(requests.shape)}")
    n_ops, n_banks = requests.shape
    if n_ops < 1 or n_banks < 1:
        raise ValueError(f"need n_ops and banks >= 1, got {(n_ops, n_banks)}")
    if n_ops % min(OP_BLOCK, n_ops):
        raise ValueError(f"{n_ops} ops is not a multiple of {OP_BLOCK}")


def carry_arbiter_plain(requests: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch on the port's int64 words:
    each cycle grants the lowest set bit (``v & -v``) and clears it."""
    v = requests.to(torch.int64) & WORD_MASK
    grants = []
    for _ in range(MAX_CYCLES):
        grant = v & -v
        grants.append(grant)
        v = v ^ grant
    return torch.stack(grants, dim=1)


def kernel_words(requests: torch.Tensor) -> torch.Tensor:
    """The words the kernel reads: the requests themselves when they are a
    contiguous int32 or int64 tensor; any other integer type, or a
    non-contiguous view, is first copied to contiguous int64 words (one
    conversion launch; the low 32 bits are kept either way)."""
    if requests.dtype in KERNEL_DTYPES and requests.is_contiguous():
        return requests
    return requests.to(torch.int64).contiguous()


def arbiter_launch(words: torch.Tensor,
                   out_dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """One launch: (ops, B) contiguous int32 or int64 words on the card ->
    (ops, 16, B) grant words of ``out_dtype`` (int64: zero-extended; int32:
    the 32-bit patterns as uint32)."""
    n_ops, n_banks = words.shape
    grants = torch.empty((n_ops, MAX_CYCLES, n_banks), dtype=out_dtype,
                         device=words.device)
    ARBITER(words.data_ptr(), words.element_size(), grants.data_ptr(),
            grants.element_size(), n_ops, n_banks)
    return grants


def arbiter_words(words: torch.Tensor) -> torch.Tensor:
    """The kernel alone on 32-bit words: (ops, B) int32 words on the card
    -> (ops, 16, B) int32 grant words (the same 32-bit patterns as
    uint32)."""
    return arbiter_launch(words, torch.int32)


def carry_arbiter(requests: torch.Tensor) -> torch.Tensor:
    """(ops, B) request words (any integer type; the low 32 bits count, as
    the reference's ``astype(uint32)``) -> (ops, 16, B) int64 one-hot grant
    words: the CUDA kernel on a CUDA tensor (one launch on contiguous int32
    or int64 words, ``kernel_words`` says which; at most ``MAX_BANKS``
    banks), the plain version on a CPU one."""
    check_arbiter(requests)
    if requests.device.type == "cpu":
        return carry_arbiter_plain(requests)
    require_cuda(requests)
    if requests.shape[1] > MAX_BANKS:
        raise ValueError(f"{requests.shape[1]} banks: the kernel takes at "
                         f"most {MAX_BANKS}")
    return arbiter_launch(kernel_words(requests))


def _request_ops(req: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(ops, B) packed request words -> ((ops, LANES) bank ids, active
    mask): op o's lane l addresses the bank whose bit l is set."""
    bits = (req[:, None, :] >> np.arange(LANES, dtype=np.uint32)[None, :,
                                         None]) & 1      # (ops, LANES, B)
    return bits.argmax(axis=-1), bits.any(axis=-1)


def _words(requests) -> np.ndarray:
    return np.asarray(host_array(requests)).astype(np.uint32)


def carry_arbiter_trace(arch, requests, **_):
    """The lane→bank stream implied by packed request words: op o's lane l
    addresses the bank whose bit l is set in ``requests[o]`` (lanes with no
    request are masked off).  Costing this trace under a B-bank architecture
    reproduces the arbiter's own grant-cycle count."""
    from repro_torch.core.trace import AddressTrace
    addrs, mask = _request_ops(_words(requests))
    return AddressTrace.from_ops(addrs, kind="load", mask=mask)


def carry_arbiter_symbolic(arch, requests, **_):
    """The arbiter's lane→bank stream for the symbolic conflict prover:
    request words are data-dependent, so the family is the exact unpacked
    (ops, LANES) matrix and its active mask, proved through the
    independent bincount conflict algorithm."""
    from repro_torch.analysis.symbolic import DataFamily, SymbolicTrace
    addrs, mask = _request_ops(_words(requests))
    fam = DataFamily(name="arbiter requests", kind="load",
                     addrs=addrs, mask=mask)
    return SymbolicTrace(families=(fam,), meta={"kernel": "carry_arbiter"})


def carry_arbiter_trace_blocks(arch, requests, block_ops=None, **_):
    """Streaming counterpart of ``carry_arbiter_trace``: the request words
    are unpacked chunk by chunk (the (ops, LANES, B) bit tensor exists only
    per block), yielded as one carry-continued load instruction — bit-equal
    to the dense trace under every architecture."""
    from repro_torch.core.trace import AddressTrace
    req = _words(requests)
    if block_ops is not None and block_ops <= 0:
        raise ValueError(f"block_ops must be positive, got {block_ops}")
    step = max(1, req.shape[0]) if block_ops is None else block_ops
    for start in range(0, req.shape[0], step):
        addrs, mask = _request_ops(req[start:start + step])
        blk = AddressTrace.from_ops(addrs, kind="load", mask=mask)
        if start:
            blk.meta["instr_carry"] = True
        yield blk
