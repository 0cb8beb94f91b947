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
from repro_torch.kernels.cuda_lib import CudaEntry, current_stream

#: the reference kernel's block of requests: R must be a multiple of
#: min(R_BLOCK, R)
R_BLOCK = 512
#: the CUDA kernel's tile of requests and its experts per pass (kTile and
#: kChunk of csrc/moe_dispatch.cu)
TILE, EXPERT_CHUNK = 8192, 1024
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1

#: the look-back's status word (kFlagBit, kTagShift, kTagLimit of the
#: source): the count in bits 0-31, the flag in bit 32 (1: inclusive
#: prefix, 0: the tile's aggregate), the call's tag (1 to TAG_LIMIT; 0 is
#: never valid) in bits 33-63
FLAG_BIT, TAG_SHIFT, TAG_LIMIT = 32, 33, 2 ** 31 - 1
#: the workspace's header (ticket, done counter, epoch) in int64 words
HEADER_WORDS = 2

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the C entry, one launch a pass of up to 1024 experts (one with none),
#: and its launch count (``DISPATCH.launches``)
DISPATCH = CudaEntry("moe_dispatch", "moe_dispatch_launch",
                     [_P, _I32, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                      _P, _I64])


def pack_status(tag: int, inclusive: bool, count: int) -> int:
    """The status word a tile publishes for one expert, as an int64 (the
    workspace's dtype): ``count`` (0 <= count < 2^32) in bits 0-31, the
    flag in bit 32 and ``tag`` (1 <= tag <= TAG_LIMIT) in bits 33-63."""
    if not (0 <= count < 2 ** 32 and 0 <= tag <= TAG_LIMIT):
        raise ValueError(f"tag {tag} or count {count} out of range")
    word = tag << TAG_SHIFT | int(inclusive) << FLAG_BIT | count
    return word - 2 ** 64 if word >= 2 ** 63 else word


def unpack_status(word: int) -> tuple[int, bool, int]:
    """(tag, inclusive, count) of a status word."""
    word %= 2 ** 64
    return word >> TAG_SHIFT, bool(word >> FLAG_BIT & 1), word & 0xFFFFFFFF


def workspace_words(r: int, n_experts: int) -> int:
    """The int64 words a call of R requests over n_experts needs: the header
    and one status word per (tile, expert of a pass)."""
    return HEADER_WORDS + -(-r // TILE) * min(n_experts, EXPERT_CHUNK)


_WORKSPACES: dict[tuple[int, int], torch.Tensor] = {}
#: workspaces replaced by larger ones, kept alive: a CUDA graph that
#: captured a call still launches on the old one's address
_RETIRED: list[torch.Tensor] = []


def workspace(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The look-back's workspace for calls on ``stream`` of ``device``: at
    least ``words`` int64 words, zeroed when allocated and then kept
    consistent by the kernel alone (its epoch advances on the device).
    Keyed by (device, stream), so calls on two streams never share one:
    calls on one stream run in order, and a captured call replays on the
    workspace of the stream it was captured on (graphs captured on one
    stream share it with each other and with that stream's eager calls,
    so none of these may overlap).

    Never made or grown while the stream captures a CUDA graph: the zero
    fill would become a node of that graph and run only when it is
    replayed, and another graph on the same workspace could run first.
    Such a call is refused; one eager call on the stream the graph is
    captured on (``torch.cuda.graph(g, stream=s)``), with at least as many
    requests and experts, makes the workspace first."""
    key = (device.index, stream)
    ws = _WORKSPACES.get(key)
    if ws is None or ws.numel() < words:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"moe_dispatch: no zeroed workspace of {words} words for "
                f"this stream, and none is made during a CUDA graph "
                f"capture; call moe_dispatch_positions once eagerly on the "
                f"stream the graph is captured on, with at least as many "
                f"requests and experts")
        if ws is not None:
            _RETIRED.append(ws)
        size = max(words, 2 * ws.numel()) if ws is not None else words
        ws = _WORKSPACES[key] = torch.zeros(size, dtype=torch.int64,
                                            device=device)
    return ws


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
    plain version on a CPU one.

    On the card: one launch a pass of up to 1024 experts (one with none);
    int32 and int64 ids go to the kernel as they are (int64 ids keep their
    low 32 bits, as ``astype(int32)``), other integer types are narrowed
    first; ``pos`` and ``kept`` are views of one allocation.  A stream of
    2^31 requests or more is refused: positions are int32."""
    check_dispatch(experts, n_experts, capacity)
    if experts.device.type == "cpu":
        return moe_dispatch_plain(experts, n_experts, capacity)
    require_cuda(experts)
    ids = experts if experts.dtype in (torch.int32, torch.int64) else \
        experts.to(torch.int32)
    ids = ids.contiguous()
    r = ids.shape[0]
    if r > INT32_MAX:
        raise ValueError(f"{r} requests: positions are int32")
    ws = workspace(ids.device, current_stream(),
                   workspace_words(r, n_experts))
    out = torch.empty(5 * r, dtype=torch.uint8, device=ids.device)
    pos, kept = out[:4 * r].view(torch.int32), out[4 * r:].view(torch.bool)
    for e_lo in range(0, max(n_experts, 1), EXPERT_CHUNK):
        DISPATCH(ids.data_ptr(), ids.element_size(), pos.data_ptr(),
                 kept.data_ptr(), r, n_experts, e_lo,
                 min(EXPERT_CHUNK, n_experts - e_lo), capacity, e_lo == 0,
                 ws.data_ptr(), ws.numel())
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
