"""Batched streaming cost engine (port of ``repro.core.cost_engine``):
price a whole architecture list against one trace in one pass on the
device, and million-op traces in O(block) memory.

Every timing model in the comparison is element-wise integer arithmetic
over a small parameter set:

  * banked:      bank = (((a >> sh) ^ (a >> xsh)) + (a >> ash)) mod B;
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
dense, chunked and streamed costing are bit-equal.  (The reference's
``prefetch=`` pipeline, ``BlockCostCache`` and ``checked=`` validation come
with the trace-cost slice.)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core import controllers as ctl
from repro_torch.core.conflicts import first_occurrence
from repro_torch.core.memsim import MemSpec, TraceCost
from repro_torch.core.trace import KIND_LOAD, KIND_STORE, KIND_TW, as_trace

__all__ = ["cost_many", "lower_archs", "ArchTable", "DEFAULT_BLOCK_OPS",
           "STREAM_THRESHOLD"]

#: block size ``MemoryArchitecture.cost`` auto-chunks with above
#: ``STREAM_THRESHOLD`` ops (bit-equal either way)
DEFAULT_BLOCK_OPS = 4096
STREAM_THRESHOLD = 1 << 15

#: shifting an int32 word address by 31 yields 0 (addresses are
#: non-negative) — the identity element for the formula's unused terms
_NO_SHIFT = 31

#: parameter-table fields per architecture and read/write path (the
#: reference's layout; the two-level columns stay 1 until that slice)
(_F_BANKED, _F_NBANKS, _F_SH, _F_XSH, _F_ASH, _F_UNIQ, _F_PORTS,
 _F_OUTB, _F_OUTG) = range(9)
_N_FIELDS = 9

_KINDS = (KIND_LOAD, KIND_STORE, KIND_TW)


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
        read = (1, spec.n_banks, sh, xsh, ash, int(spec.broadcast), 1, 1, 1)
        write = (1, spec.n_banks, sh, xsh, ash, 0, 1, 1, 1)
        return read, write, (ctl.read_overhead(spec.n_banks),
                             ctl.write_overhead(spec.n_banks))
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
    banked row has a non-pow2 bank count (``% B`` instead of the mask)."""

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


def _block_kind_cycles(params: torch.Tensor, addrs: torch.Tensor,
                       mask: torch.Tensor, kinds: torch.Tensor, *,
                       need_uniq: bool, need_mod: bool) -> torch.Tensor:
    """One block, every architecture: (n_archs, 3) int64 per-kind cycle sums.

    params (A, 2, 9) int32, addrs (n_ops, LANES) int32, mask (n_ops, LANES)
    bool, kinds (n_ops,) int64, all on one device.

    The banked max-conflict comes from the lane-pair equality matrix: an
    active lane's count of same-bank active lanes is its bank's popcount,
    so the max over active lanes is the max over banks, with LANES² cells
    per op whatever the bank count."""
    is_write = (kinds == KIND_STORE)[None, :, None]               # (1, n, 1)
    active = mask.sum(dim=-1, dtype=torch.int32)                  # (n,)
    uniq = first_occurrence(addrs, mask).bool() if need_uniq else mask
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
    eff = mask[None] & torch.where(field(_F_UNIQ)[..., None].bool(),
                                   uniq[None], True)              # (A, n, L)
    eq = (bank[..., :, None] == bank[..., None, :]) & eff[..., None, :]
    cnt = eq.sum(dim=-1, dtype=torch.int32)                       # (A, n, L)
    banked = torch.where(eff, cnt, 0).amax(dim=-1)                # (A, n)
    ports = field(_F_PORTS)
    ported = (active[None] + ports - 1) // ports
    cyc = torch.where(field(_F_BANKED).bool(), banked, ported).to(torch.int64)
    kind_onehot = (kinds[:, None] == torch.tensor(
        _KINDS, device=kinds.device)).to(torch.int64)             # (n, 3)
    return (cyc[:, :, None] * kind_onehot[None]).sum(dim=1)       # (A, 3)


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
        for i, kind in enumerate(_KINDS):
            sel = blk.kinds == kind
            n = int(sel.sum())
            if not n:
                continue
            self.n_ops[i] += n
            ids = np.unique(blk.instr[sel])
            add = ids.size
            if self._last.get(kind) == int(ids[0]):
                add -= 1
            self._last[kind] = int(ids[-1])
            self.n_instr[i] += add


def cost_many(archs, trace, block_ops: int | None = None,
              device="cuda") -> list[TraceCost]:
    """Price every architecture of ``archs`` against one trace, with the
    per-op conflict arithmetic on ``device`` and one device sync in all.

    ``trace`` is anything ``trace.as_trace`` accepts: a dense
    ``AddressTrace``, a lazy ``TraceStream`` or a raw iterable / callable of
    ``AddressTrace`` blocks.  ``block_ops`` chunks every block to at most
    that many ops (bounding peak memory); small blocks are coalesced into
    one device pass of up to that many ops.  Dense, chunked and streamed
    costing are bit-equal.  Returns one ``TraceCost`` per architecture, in
    input order."""
    from repro_torch.core import arch as _arch
    arch_objs = [_arch.resolve(a) for a in archs]
    if not arch_objs:
        return []
    device = torch.device(device)
    table = _lowered(tuple(a.spec for a in arch_objs))
    params = torch.from_numpy(table.params).to(device)
    n_archs = len(arch_objs)
    totals = torch.zeros((n_archs, 3), dtype=torch.int64, device=device)

    counter = _InstrCounter()
    compute_cycles = 0
    op_counts: dict = {}
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
        totals += _block_kind_cycles(
            params, torch.from_numpy(addrs).to(device),
            torch.from_numpy(mask).to(device),
            torch.from_numpy(kinds.astype(np.int64)).to(device),
            need_uniq=table.need_uniq, need_mod=table.need_mod)

    for blk in as_trace(trace).blocks(block_ops):
        compute_cycles += blk.compute_cycles
        for k, v in blk.op_counts.items():
            op_counts[k] = op_counts.get(k, 0) + v
        if not blk.n_ops:
            continue
        counter.add(blk)
        pending.append((blk.addrs,
                        np.ones_like(blk.addrs, bool) if blk.mask is None
                        else blk.mask,
                        blk.kinds))
        pending_ops += blk.n_ops
        if pending_ops >= target:
            _flush()
    _flush()
    host = totals.cpu().numpy()                  # the one device sync
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
