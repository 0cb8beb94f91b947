"""MoE dispatch positions — the carry-chain arbiter's grant order at router
scale: for a flat, priority-ordered stream of expert ids (all first
choices in token order, then the second choices: the FPGA's lane order),
each request's position within its expert and whether it fits the
capacity.

``moe_dispatch_positions`` is the wrapper: for a CUDA tensor it launches
the hand-written kernel of ``csrc/moe_dispatch.cu`` (which replaces the
Pallas ``moe_dispatch_kernel`` of
``src/repro/kernels/moe_dispatch/kernel.py``; the source says what bounds
it and how the design answers that), for a CPU tensor it runs
``moe_dispatch_plain``, the same function in plain PyTorch.  There is no
fallback from one to the other.  The trace generators give the expert-id
stream as one store instruction.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.banked_gather.ops import require_cuda
from repro_torch.kernels.cuda_lib import CudaEntry

#: the reference kernel's block of requests: R must be a multiple of
#: min(R_BLOCK, R)
R_BLOCK = 512
#: the CUDA kernel's tile of requests and its experts per pass (kTile and
#: kChunk of csrc/moe_dispatch.cu): the size of its scratch buffer
TILE, EXPERT_CHUNK = 4096, 1024
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the three C entries, one launch each (their ``launches``), called in
#: this order once per chunk of up to 1024 experts; with no experts the
#: rank launch runs alone
HIST = CudaEntry("moe_dispatch", "moe_dispatch_hist",
                 [_P, _P, _I64, _I32, _I32, _I32])
SCAN = CudaEntry("moe_dispatch", "moe_dispatch_scan", [_P, _I32, _I32])
RANK = CudaEntry("moe_dispatch", "moe_dispatch_rank",
                 [_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P, _I32, _I32])
ENTRIES = (HIST, SCAN, RANK)


class _DispatchLaunches:
    """The launches of the dispatch: the sum of its three entries' counts.
    Setting ``launches`` to 0 zeroes all three."""

    @property
    def launches(self) -> int:
        return sum(e.launches for e in ENTRIES)

    @launches.setter
    def launches(self, n: int) -> None:
        if n:
            raise ValueError("the dispatch's launch count resets to 0 only")
        for e in ENTRIES:
            e.launches = 0


#: the dispatch's launch count (``DISPATCH.launches``)
DISPATCH = _DispatchLaunches()


def check_dispatch(experts: torch.Tensor, n_experts: int,
                   capacity: int) -> None:
    """What the reference refuses: ids that are not one (R,) vector, R = 0
    (its ``r % blk`` divides by zero), R > 512 not a multiple of 512
    (``assert r % blk == 0``), n_experts < 0, and a capacity outside int32
    (it overflows the int32 comparison).  Checked on either path."""
    if experts.dim() != 1:
        raise ValueError(f"need an (R,) id vector, got {tuple(experts.shape)}")
    r = experts.shape[0]
    if r < 1:
        raise ValueError("need at least one request")
    if r % min(R_BLOCK, r):
        raise ValueError(f"{r} requests is not a multiple of {R_BLOCK}")
    if n_experts < 0:
        raise ValueError(f"n_experts must be >= 0, got {n_experts}")
    if not INT32_MIN <= capacity <= INT32_MAX:
        raise ValueError(f"capacity {capacity} does not fit int32")


def moe_dispatch_plain(experts: torch.Tensor, n_experts: int, capacity: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: the exclusive cumsum of the
    one-hot of the ids (narrowed to int32) over the stream, picked at each
    request's own expert, and ``pos < capacity``, as the reference's oracle
    computes it; ids outside [0, n_experts) count nowhere and get 0.

    The one-hot is scanned one expert's row at a time, so no tensor is
    larger than the stream: the whole (R, E) one-hot at 2^24 requests and
    E = 128 holds 2^31 elements, and a scan down it runs E scans of length
    R side by side (seconds a call on the card)."""
    ids = experts.to(torch.int32)
    pos = torch.zeros_like(ids)
    for e in range(n_experts):
        hit = ids == e
        pos = torch.where(hit, hit.cumsum(0, dtype=torch.int32) - 1, pos)
    return pos, pos < capacity


def moe_dispatch_positions(experts: torch.Tensor, n_experts: int,
                           capacity: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(R,) flat priority-ordered expert ids -> ((R,) int32 position within
    the expert, (R,) bool kept): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU one."""
    check_dispatch(experts, n_experts, capacity)
    if experts.device.type == "cpu":
        return moe_dispatch_plain(experts, n_experts, capacity)
    require_cuda(experts)
    ids = experts.to(torch.int32).contiguous()      # as astype(jnp.int32)
    r = ids.shape[0]
    pos = torch.empty(r, dtype=torch.int32, device=ids.device)
    kept = torch.empty(r, dtype=torch.bool, device=ids.device)
    n_tiles = -(-r // TILE)
    hist = torch.empty((min(n_experts, EXPERT_CHUNK), n_tiles),
                       dtype=torch.int32, device=ids.device)
    for e_lo in range(0, max(n_experts, 1), EXPERT_CHUNK):
        ew = min(EXPERT_CHUNK, n_experts - e_lo)
        if ew:
            HIST(ids.data_ptr(), hist.data_ptr(), r, e_lo, ew, n_tiles)
            SCAN(hist.data_ptr(), ew, n_tiles)
        RANK(ids.data_ptr(), pos.data_ptr(), kept.data_ptr(), r, n_experts,
             e_lo, ew, n_tiles, hist.data_ptr(), capacity, e_lo == 0)
    return pos, kept


def moe_dispatch_trace(arch, experts, n_experts, capacity, **_):
    """The dispatch's AddressTrace: the priority-ordered expert-id stream
    as one store instruction (experts play the role of banks — the
    arbiter's write-side occupancy at MoE scale)."""
    from repro_torch.kernels.registry import row_stream_trace
    return row_stream_trace(experts, kind="store")


def moe_dispatch_trace_blocks(arch, experts, n_experts, capacity,
                              block_ops=None, **_):
    """Streaming counterpart of ``moe_dispatch_trace``: the expert-id
    stream as at-most-``block_ops``-op blocks of the same one store
    instruction (bit-equal costing, O(block) construction)."""
    from repro_torch.kernels.registry import row_stream_blocks
    yield from row_stream_blocks(experts, kind="store", block_ops=block_ops)
