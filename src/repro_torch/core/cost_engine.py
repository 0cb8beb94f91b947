"""Batched streaming cost engine (port of ``repro.core.cost_engine``):
price a whole architecture list against one trace in one pass on the
device, and million-op traces in O(block) memory.

Every timing model in the comparison is element-wise integer arithmetic
over a small parameter set:

  * banked:      bank = (((a >> sh) ^ (a >> xsh)) + (a >> ash)) mod B
                 [+ B · ((a // G) mod O) for two-level macro hierarchies];
                 cycles = max per-bank popcount (optionally over distinct
                 addresses — the broadcast variant)
  * multi-port:  cycles = ceil(active_lanes / ports); the -VB write path is
                 the banked formula over 4 pseudo-banks

so the lattice lowers to one ``(n_archs, 2 paths, 9)`` int32 parameter
table (``lower_archs``, the same rows as the reference) and
``_block_kind_cycles`` prices every architecture against a block at once,
in plain torch on the trace's target device.  Blocks are host numpy
arrays; they move host→device in ``cost_many``, per-block partials stay on
the device, and the totals come back with one device sync per call.

Per-instruction controller overheads are charged on the host from the
protocol's global instruction ids by a streaming distinct-id count, so
dense, chunked and streamed costing are bit-equal.

Two optional paths, each bit-equal to the plain serial pass:

  * ``cost_many(..., prefetch=N)`` builds upcoming host blocks while the
    device prices the current batch: thunk-backed streams
    (``TraceStream.from_thunks``) on an N-worker pool, other streams on
    one producer thread.  Blocks are consumed in stream order; the
    producers never touch the device, and a producer's exception is
    re-raised in the caller.
  * ``cost_many(..., cache=BlockCostCache())`` memoizes each block's
    ``(n_archs, 3)`` int64 partial under (arch-table digest, block content
    digest): a re-priced window that shares blocks with an earlier one
    sends only the new blocks to the device.

``cost_many(..., checked=True)`` validates the Trace protocol on every
block as it is priced (``repro_torch.analysis.contracts``); the default
defers to the process-wide ``checking()`` switch.
"""
from __future__ import annotations

import functools
import hashlib
import queue
import threading
import weakref
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.core import controllers as ctl
from repro_torch.core.conflicts import first_occurrence
from repro_torch.core.memsim import LANES, MemSpec, TraceCost
from repro_torch.core.trace import (KIND_LOAD, KIND_STORE, KIND_TW,
                                    AddressTrace, TraceStream, _id_runs,
                                    as_trace)

__all__ = ["cost_many", "lower_archs", "ArchTable", "BlockCostCache",
           "DEFAULT_BLOCK_OPS", "STREAM_THRESHOLD"]

#: block size ``MemoryArchitecture.cost`` auto-chunks with above
#: ``STREAM_THRESHOLD`` ops (bit-equal either way)
DEFAULT_BLOCK_OPS = 4096
STREAM_THRESHOLD = 1 << 15

#: shifting an int32 word address by 31 yields 0 (addresses are
#: non-negative) — the identity element for the formula's unused terms
_NO_SHIFT = 31

#: parameter-table fields per architecture and read/write path (the
#: reference's layout).  ``n_banks`` is the INNER bank count (1 for pure
#: multi-port paths); two-level rows carry outer_banks > 1, and the flat
#: bank id the arbiter sees is ``inner + n_banks · outer``
(_F_BANKED, _F_NBANKS, _F_SH, _F_XSH, _F_ASH, _F_UNIQ, _F_PORTS,
 _F_OUTB, _F_OUTG) = range(9)
_N_FIELDS = 9

_KINDS = (KIND_LOAD, KIND_STORE, KIND_TW)
assert _KINDS == (0, 1, 2)       # _block_kind_cycles one-hots by arange

#: fold the cache path's device partials into the host totals every N
#: missed blocks: one sync per fold, never one per miss
_FOLD_EVERY = 256


def _map_shifts(mapping: str, n_banks: int, shift: int) -> tuple:
    """(sh, xsh, ash) with bank = (((a >> sh) ^ (a >> xsh)) + (a >> ash))
    mod B reproducing ``bankmap.bank_of`` for every map."""
    log2b = n_banks.bit_length() - 1
    if mapping == "lsb":
        return 0, _NO_SHIFT, _NO_SHIFT
    if mapping == "offset":
        return shift, _NO_SHIFT, _NO_SHIFT
    if mapping == "xor":
        return 0, log2b, _NO_SHIFT
    if mapping == "fold":
        return 0, _NO_SHIFT, log2b
    raise ValueError(f"unknown bank map {mapping!r}")


def _spec_paths(spec: MemSpec) -> tuple:
    """One spec -> ((read path), (write path), (read_ovh, write_ovh))."""
    if spec.is_banked:
        sh, xsh, ash = _map_shifts(spec.mapping, spec.n_banks, spec.map_shift)
        outb = spec.outer_banks if spec.is_two_level else 1
        outg = spec.outer_granule if spec.is_two_level else 1
        read = (1, spec.n_banks, sh, xsh, ash, int(spec.broadcast), 1,
                outb, outg)
        write = (1, spec.n_banks, sh, xsh, ash, 0, 1, outb, outg)
        # the controllers arbitrate over every flat bank: a 4x4B pays the
        # overhead of 16 banks, not 4
        return read, write, (ctl.read_overhead(spec.total_banks),
                             ctl.write_overhead(spec.total_banks))
    read = (0, 1, _NO_SHIFT, _NO_SHIFT, _NO_SHIFT, 0, spec.read_ports, 1, 1)
    if spec.vb_write_banks:
        write = (1, spec.vb_write_banks, 0, _NO_SHIFT, _NO_SHIFT, 0, 1, 1, 1)
        return read, write, (0, ctl.write_overhead(spec.vb_write_banks))
    write = (0, 1, _NO_SHIFT, _NO_SHIFT, _NO_SHIFT, 0, spec.write_ports, 1, 1)
    return read, write, (0, 0)


class ArchTable:
    """A lowered architecture list: ``params`` (n_archs, 2, 9) int32 — per
    arch a read-path and a write-path row — and ``overheads`` (n_archs, 2)
    per-instruction controller overheads (read, write).  ``need_uniq``:
    some read path coalesces same-address requests; ``need_mod``: some
    banked row has a non-pow2 bank count (``% B`` instead of the mask);
    ``need_two_level``: some row has an outer level (the macro term).

    ``remaps`` (n_archs, 2, W) int32 is the degraded-mode bank remap
    (``arch.surviving_bank_remap``) applied to the formula's flat bank id
    (inner + n_banks·outer for two-level), identity-padded to the
    lattice's widest flat bank count; ``need_remap`` is False for an
    all-healthy lattice, which then prices without the lookup.

    ``digest`` content-addresses the lowered table (params, remaps,
    overheads, flags): the arch half of every ``BlockCostCache`` key, so a
    degraded variant keys apart from its base."""

    def __init__(self, specs: tuple):
        rows, ovhs = [], []
        for s in specs:
            read, write, ovh = _spec_paths(s)
            rows.append((read, write))
            ovhs.append(ovh)
        self.specs = specs
        self.params = np.asarray(rows, np.int32).reshape(
            len(specs), 2, _N_FIELDS)
        self.overheads = np.asarray(ovhs, np.int64).reshape(len(specs), 2)
        self.need_uniq = bool(self.params[:, 0, _F_UNIQ].any())
        banked = self.params[:, :, _F_BANKED].astype(bool)
        nb = self.params[:, :, _F_NBANKS]
        self.need_mod = bool((banked & (nb & (nb - 1) != 0)).any())
        self.need_two_level = bool((self.params[:, :, _F_OUTB] > 1).any())
        width = max(1, int((nb * self.params[:, :, _F_OUTB]).max()))
        self.remaps = np.tile(np.arange(width, dtype=np.int32),
                              (len(specs), 2, 1))
        self.need_remap = False
        for i, s in enumerate(specs):
            if not s.dead_banks:
                continue
            from repro_torch.core.arch import surviving_bank_remap
            # both paths share the data banks (the -VB pseudo-bank write
            # path is multi-port only, and multi-port specs never degrade)
            self.remaps[i, :, :s.total_banks] = surviving_bank_remap(
                s.total_banks, s.dead_banks)
            self.need_remap = True
        self._digest: bytes | None = None
        self._on: dict = {}

    def _uploaded(self, name: str, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
        t = self._on.get((name, device))
        if t is None:
            t = self._on[name, device] = torch.from_numpy(
                getattr(self, name)).to(device=device, dtype=dtype)
        return t

    def params_on(self, device: torch.device) -> torch.Tensor:
        """``params`` on ``device``, uploaded once per table and device."""
        return self._uploaded("params", device, torch.int32)

    def remaps_on(self, device: torch.device) -> torch.Tensor:
        """``remaps`` on ``device`` as int64 gather indices, uploaded once
        per table and device."""
        return self._uploaded("remaps", device, torch.int64)

    @property
    def digest(self) -> bytes:
        """Content digest of the lowered table."""
        if self._digest is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(self.params.tobytes())
            h.update(self.remaps.tobytes())
            h.update(self.overheads.tobytes())
            h.update(bytes([self.need_uniq, self.need_remap,
                            self.need_mod, self.need_two_level]))
            self._digest = h.digest()
        return self._digest

    def __len__(self) -> int:
        return len(self.specs)


@functools.lru_cache(maxsize=None)
def _lowered(specs: tuple) -> ArchTable:
    return ArchTable(specs)


def lower_archs(archs) -> ArchTable:
    """Lower a list of architectures (names / specs / objects) to the
    parameter arrays one block pass consumes (cached per spec list)."""
    from repro_torch.core import arch as _arch
    return _lowered(tuple(_arch.resolve(a).spec for a in archs))


def _block_kind_cycles(params: torch.Tensor, remaps: torch.Tensor,
                       addrs: torch.Tensor, mask: torch.Tensor,
                       kinds: torch.Tensor, *, need_uniq: bool,
                       need_remap: bool, need_mod: bool,
                       need_two_level: bool) -> torch.Tensor:
    """One block, every architecture: (n_archs, 3) int64 per-kind cycle sums.

    params (A, 2, 9) int32, remaps (A, 2, W) int64, addrs (n_ops, LANES)
    int32, mask (n_ops, LANES) bool, kinds (n_ops,) integer, all on one
    device.

    The banked max-conflict comes from the lane-pair equality matrix: an
    active lane's count of same-bank active lanes is its bank's popcount,
    so the max over active lanes is the max over banks, with LANES² cells
    per op whatever the bank count.  ``need_two_level`` adds the outer
    macro term and ``need_remap`` the degraded-bank lookup on the flat
    bank id after it; lattices without them run without them."""
    is_write = (kinds == KIND_STORE)[None, :, None]               # (1, n, 1)
    active = mask.sum(dim=-1, dtype=torch.int32)                  # (n,)
    pr = torch.where(is_write, params[:, None, 1], params[:, None, 0])
    field = functools.partial(torch.select, pr, -1)               # (A, n)
    nb = field(_F_NBANKS)[..., None]                              # (A, n, 1)
    a = addrs[None]                                               # (1, n, L)
    raw = (((a >> field(_F_SH)[..., None]) ^ (a >> field(_F_XSH)[..., None]))
           + (a >> field(_F_ASH)[..., None]))                     # (A, n, L)
    if need_mod:
        bank = raw % nb
        # int32 overflow of the xor+add form can make ``raw`` negative (pow2
        # rows sharing a mixed lattice).  Torch ``%`` takes the divisor's
        # sign, but a C or CUDA ``%`` takes the dividend's: the fold keeps
        # the bank in [0, nb) under either convention.
        bank = torch.where(bank < 0, bank + nb, bank)
    else:
        bank = raw & (nb - 1)
    if need_two_level:
        bank = bank + nb * ((a // field(_F_OUTG)[..., None])
                            % field(_F_OUTB)[..., None])
    if need_remap:          # dead banks' requests go to their survivors
        n_archs, _, width = remaps.shape
        row = (torch.arange(n_archs, device=addrs.device)[:, None, None] * 2
               + is_write)                                        # (A, n, 1)
        bank = remaps.reshape(-1)[row * width + bank]             # (A, n, L)
    if need_uniq:           # broadcast rows count distinct addresses only
        uniq = first_occurrence(addrs, mask).bool()
        eff = mask[None] & torch.where(field(_F_UNIQ)[..., None].bool(),
                                       uniq[None], True)          # (A, n, L)
    else:
        eff = mask[None]                                          # (1, n, L)
    eq = (bank[..., :, None] == bank[..., None, :]) & eff[..., None, :]
    cnt = eq.sum(dim=-1, dtype=torch.int32)                       # (A, n, L)
    banked = torch.where(eff, cnt, 0).amax(dim=-1)                # (A, n)
    ports = field(_F_PORTS)
    ported = (active[None] + ports - 1) // ports
    cyc = torch.where(field(_F_BANKED).bool(), banked, ported)    # (A, n)
    # an op whose kind code is none of (0, 1, 2) adds to no column
    kind_onehot = kinds[:, None] == torch.arange(
        len(_KINDS), device=kinds.device)                         # (n, 3)
    return (cyc[:, :, None] * kind_onehot[None]).sum(
        dim=1, dtype=torch.int64)                                 # (A, 3)


class _InstrCounter:
    """Streaming per-kind distinct-instruction counter over protocol blocks.

    Blocks arrive with globally consistent, non-decreasing instruction ids,
    so a block contributes its per-kind unique-id count, minus one when its
    first id of that kind continues the previous block's last (the
    instruction a block boundary cut): one instruction spanning any number
    of chunks pays its controller overhead once."""

    def __init__(self):
        self.n_instr = np.zeros(3, np.int64)
        self.n_ops = np.zeros(3, np.int64)
        self._last: dict = {}        # kind -> last global id seen

    def add(self, blk) -> None:
        instr = blk.instr
        # int8 kind codes as bytes: anything but 0, 1, 2 counts nowhere
        counts = np.bincount(blk.kinds.view(np.uint8), minlength=3)
        for i, kind in enumerate(_KINDS):
            n = int(counts[kind])
            if not n:
                continue
            self.n_ops[i] += n
            ids = instr if n == instr.size else instr[blk.kinds == kind]
            add, first, last = _id_runs(ids)
            if self._last.get(kind) == first:
                add -= 1
            self._last[kind] = last
            self.n_instr[i] += add


class BlockCostCache:
    """LRU memo of per-block (n_archs, 3) int64 conflict-cycle partials.

    Keys are (``ArchTable.digest``, block content digest): the block half
    covers addresses, mask and op kinds, everything ``_block_kind_cycles``
    reads.  Instruction ids are not part of the key: per-op cycles do not
    depend on them, and ``cost_many``'s streaming counter charges the
    per-instruction overhead on the host either way.  A hit replays the
    integers the device returned on the miss, so a warm re-price is
    bit-equal to a cold pass.

    ``digest_of`` memoizes the content hash by buffer identity (base
    object, data pointer, shape, strides, dtype per array, the base pinned
    by a strong reference): a rolling window re-observes the same payload
    arrays every tick.  Payload arrays are frozen (``writeable = False``)
    on first digest, so mutating a priced block raises instead of silently
    re-pricing stale bytes.  (A write through a writable view made before
    the freeze is not detected: producers that recycle buffers copy before
    pricing through a cache.)
    """

    def __init__(self, max_entries: int = 4096,
                 max_digest_memo: int = 512):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.max_digest_memo = max_digest_memo
        self._store: OrderedDict = OrderedDict()
        self._digests: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def block_digest(addrs, mask, kinds) -> bytes:
        """Content digest of one block's priced payload.  A dense block and
        the same block with an explicit all-True mask digest identically
        (they price identically)."""
        h = hashlib.blake2b(digest_size=16)
        a = np.ascontiguousarray(addrs, dtype=np.int32)
        h.update(np.int64(a.shape[0]).tobytes())
        h.update(a.tobytes())
        if mask is None:
            h.update(b"\x01")
        else:
            m = np.ascontiguousarray(mask, dtype=bool)
            if m.all():
                h.update(b"\x01")
            else:
                h.update(b"\x00")
                h.update(m.tobytes())
        h.update(np.ascontiguousarray(kinds, dtype=np.int32).tobytes())
        return h.digest()

    def digest_of(self, addrs, mask, kinds) -> bytes:
        """``block_digest`` behind the buffer-identity memo."""
        keys, pins = [], []
        for a in (addrs, mask, kinds):
            if isinstance(a, np.ndarray):
                base = a.base if a.base is not None else a
                keys.append((id(base), a.__array_interface__["data"][0],
                             a.shape, a.strides, a.dtype.str))
                pins.append((a, base))
            else:
                keys.append(None)
        key = tuple(keys)
        hit = self._digests.get(key)
        if hit is not None:
            self._digests.move_to_end(key)
            return hit[1]
        d = self.block_digest(addrs, mask, kinds)
        for a, base in pins:
            a.flags.writeable = False
            base.flags.writeable = False
        self._digests[key] = (pins, d)
        while len(self._digests) > self.max_digest_memo:
            self._digests.popitem(last=False)
        return d

    def get(self, key) -> np.ndarray | None:
        hit = self._store.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key, partial: np.ndarray) -> None:
        self._store[key] = partial
        self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def __len__(self) -> int:
        return len(self._store)

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._store),
                "digest_memo": len(self._digests)}

    def clear(self) -> None:
        self._store.clear()
        self._digests.clear()


class _ProducerError:
    """An exception forwarded from the producer thread to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _iter_thunk_result(result):
    """A thunk may return one source AddressTrace or an iterable of them."""
    if isinstance(result, AddressTrace):
        yield result
    else:
        yield from result


def _prefetched(src: TraceStream, prefetch: int) -> TraceStream:
    """A one-shot ``TraceStream`` delivering ``src``'s source blocks ahead
    of consumption, in order.

    Thunk-backed streams (``TraceStream.from_thunks``) build up to
    ``prefetch`` blocks at once on a worker pool (per-block construction
    is independent by contract; results are consumed in thunk order).
    Other streams run one producer thread over the source iterator with a
    bounded queue.  Either way the workers only build host numpy blocks;
    the caller's thread does every device call."""
    thunks = src.thunks

    if thunks:
        def gen():
            import concurrent.futures as cf
            with cf.ThreadPoolExecutor(max_workers=prefetch) as pool:
                window: deque = deque()
                for t in thunks:
                    window.append(pool.submit(t))
                    if len(window) > prefetch:
                        yield from _iter_thunk_result(
                            window.popleft().result())
                while window:
                    yield from _iter_thunk_result(window.popleft().result())

        # in-flight construction futures cannot be rewound: single-pass by
        # design, consumed exactly once by cost_many
        return TraceStream(gen(), meta=dict(src.meta))  # lint: allow-one-shot-stream

    done = object()
    stop = threading.Event()
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))

    def produce():
        try:
            for blk in src:
                while not stop.is_set():
                    try:
                        q.put(blk, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            item = done
        except BaseException as e:      # forwarded, re-raised by consumer
            item = _ProducerError(e)
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def gen():
        t = threading.Thread(target=produce, name="cost-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()

    # the producer thread drains the source once: single-pass by design
    return TraceStream(gen(), meta=dict(src.meta))  # lint: allow-one-shot-stream


class _StagingBytes:
    """The bytes of ``_upload``'s host staging buffers (pinned on the card)
    alive at once, and their peak since ``reset()``: host memory that torch
    allocates, so ``tracemalloc`` does not see it."""

    def __init__(self):
        self.live = self.peak = 0

    def reset(self) -> None:
        self.peak = self.live

    def hold(self, buf: torch.Tensor) -> None:
        n = buf.nbytes
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(buf, self._release, n)

    def _release(self, n: int) -> None:
        self.live -= n


STAGING = _StagingBytes()


def _upload(addrs: np.ndarray, mask: np.ndarray, kinds: np.ndarray,
            device: torch.device) -> tuple:
    """A host block on ``device`` as (addrs int32, mask bool, kinds int32),
    packed into one (n, 2·LANES + 1) int32 buffer so it is one copy.  On
    the card the buffer is pinned and the copy asynchronous: a copy from
    pageable memory waits for the device to drain, a sync per block."""
    pinned = device.type == "cuda"
    buf = torch.empty((addrs.shape[0], 2 * LANES + 1), dtype=torch.int32,
                      pin_memory=pinned)
    STAGING.hold(buf)
    host = buf.numpy()
    host[:, :LANES] = addrs
    host[:, LANES:2 * LANES] = mask
    host[:, 2 * LANES] = kinds
    if pinned:
        buf = buf.to(device, non_blocking=True)
    return (buf[:, :LANES], buf[:, LANES:2 * LANES].bool(),
            buf[:, 2 * LANES])


def cost_many(archs, trace, block_ops: int | None = None,
              device="cuda", prefetch: int | None = None,
              cache: BlockCostCache | None = None,
              checked: bool | None = None) -> list[TraceCost]:
    """Price every architecture of ``archs`` against one trace, with the
    per-op conflict arithmetic on ``device`` and one device sync in all.

    ``trace`` is anything ``trace.as_trace`` accepts: a dense
    ``AddressTrace``, a lazy ``TraceStream`` or a raw iterable / callable of
    ``AddressTrace`` blocks.  ``block_ops`` chunks every block to at most
    that many ops (bounding peak memory); small blocks are coalesced into
    one device pass of up to that many ops.  Dense, chunked and streamed
    costing are bit-equal.

    ``prefetch=N`` (N >= 1) builds up to N upcoming source blocks on the
    host while the device prices earlier ones (an N-worker pool for
    ``TraceStream.from_thunks`` streams, one producer thread otherwise);
    bit-equal to the serial pass.

    ``cache`` attaches a ``BlockCostCache``: blocks found there (by content
    digest, under this arch list's table digest) skip the device and add
    their memoized partial on the host.  With a cache the engine prices
    block at a time instead of coalescing; missed partials stay on the
    device until they are folded every ``_FOLD_EVERY`` misses.

    ``checked=True`` validates the Trace protocol contracts (globally
    non-decreasing instruction ids, legal ``instr_carry`` chains, shapes,
    non-negative addresses) on every block as it is priced, in the
    stream's one pass, and raises ``TraceContractError`` on a violation;
    ``False`` skips it, and ``None`` defers to the process-wide switch
    ``repro_torch.analysis.contracts.checking()``.  A checked call prices
    bit-equal to an unchecked one.

    Returns one ``TraceCost`` per architecture, in input order."""
    from repro_torch.core import arch as _arch
    arch_objs = [_arch.resolve(a) for a in archs]
    if not arch_objs:
        return []
    device = torch.device(device)
    table = _lowered(tuple(a.spec for a in arch_objs))
    params, remaps = table.params_on(device), table.remaps_on(device)
    n_archs = len(arch_objs)

    def _dispatch(addrs, mask, kinds) -> torch.Tensor:
        return _block_kind_cycles(
            params, remaps, *_upload(addrs, mask, kinds, device),
            need_uniq=table.need_uniq, need_remap=table.need_remap,
            need_mod=table.need_mod, need_two_level=table.need_two_level)

    counter = _InstrCounter()
    compute_cycles = 0
    op_counts: dict = {}

    def _account(blk) -> bool:
        """Host-side totals of one block; False when it has no ops."""
        nonlocal compute_cycles
        compute_cycles += blk.compute_cycles
        for k, v in blk.op_counts.items():
            op_counts[k] = op_counts.get(k, 0) + v
        if not blk.n_ops:
            return False
        counter.add(blk)
        return True

    def _mask(blk) -> np.ndarray:
        return (np.ones_like(blk.addrs, bool) if blk.mask is None
                else blk.mask)

    src = as_trace(trace)
    if prefetch is not None:
        if prefetch < 1:
            raise ValueError(f"prefetch must be >= 1, got {prefetch}")
        if isinstance(src, TraceStream):     # dense traces: nothing to
            src = _prefetched(src, prefetch)  # build ahead of time
    blocks = src.blocks(block_ops)
    if checked is None or checked:
        # analysis imports core, never the reverse at module level: this
        # lazy import is the one upward hook
        from repro_torch.analysis import contracts as _contracts
        if checked or _contracts.is_checking():
            n_words = (src.meta.get("n_words")
                       if isinstance(getattr(src, "meta", None), dict)
                       else None)
            blocks = _contracts.checked_blocks(blocks, n_words=n_words,
                                               where="cost_many(checked)")

    if cache is not None:
        # block at a time: a hit adds its stored int64 partial on the host;
        # a miss is priced on the device and stored when folded
        host = np.zeros((n_archs, 3), np.int64)
        in_flight: list = []             # (key, device partial)

        def _fold_misses():
            nonlocal host
            if not in_flight:
                return
            parts = torch.stack([p for _, p in in_flight]).cpu().numpy()
            for (key, _), part in zip(in_flight, parts):
                cache.put(key, part)
                host = host + part
            in_flight.clear()

        for blk in blocks:
            if not _account(blk):
                continue
            key = (table.digest,
                   cache.digest_of(blk.addrs, blk.mask, blk.kinds))
            hit = cache.get(key)
            if hit is not None:
                host = host + hit
                continue
            in_flight.append((key, _dispatch(blk.addrs, _mask(blk),
                                             blk.kinds)))
            if len(in_flight) >= _FOLD_EVERY:
                _fold_misses()
        _fold_misses()
    else:
        totals = None
        target = block_ops if block_ops is not None else DEFAULT_BLOCK_OPS
        pending: list = []
        pending_ops = 0

        def _flush():
            nonlocal totals, pending_ops
            if not pending:
                return
            addrs, mask, kinds = (np.concatenate(parts)
                                  for parts in zip(*pending))
            pending.clear()
            pending_ops = 0
            part = _dispatch(addrs, mask, kinds)
            totals = part if totals is None else totals + part

        for blk in blocks:
            if not _account(blk):
                continue
            pending.append((blk.addrs, _mask(blk), blk.kinds))
            pending_ops += blk.n_ops
            if pending_ops >= target:
                _flush()
        _flush()
        host = (np.zeros((n_archs, 3), np.int64) if totals is None
                else totals.cpu().numpy())       # the one device sync
    n_instr, n_ops = counter.n_instr, counter.n_ops

    costs = []
    for i in range(n_archs):
        r_ovh, w_ovh = (int(table.overheads[i, 0]),
                        int(table.overheads[i, 1]))
        costs.append(TraceCost(
            load_cycles=(int(host[i, 0]) + int(n_instr[0]) * r_ovh
                         if n_ops[0] else 0),
            store_cycles=(int(host[i, 1]) + int(n_instr[1]) * w_ovh
                          if n_ops[1] else 0),
            tw_load_cycles=(int(host[i, 2]) + int(n_instr[2]) * r_ovh
                            if n_ops[2] else 0),
            compute_cycles=int(compute_cycles),
            n_load_ops=int(n_ops[0]), n_store_ops=int(n_ops[1]),
            n_tw_ops=int(n_ops[2]),
            fp_ops=int(op_counts.get("fp", 0)),
            int_ops=int(op_counts.get("int", 0)),
            imm_ops=int(op_counts.get("imm", 0)),
            other_ops=int(op_counts.get("other", 0))))
    return costs
