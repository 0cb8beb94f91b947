"""Memory-architecture API (port of ``repro.core.arch``).

  * ``MemoryArchitecture`` — one shared-memory variant: conflict/cycle
    model, fmax and trace costing (``cost`` over the batched engine), and
    the area model's hooks (``resources``, ``footprint_alms``,
    ``processor_footprint_alms``: ``repro_torch.core.cost``).
  * ``BankedMemory`` / ``MultiPortMemory`` — the two families of paper
    §I/§III, wrapping a frozen ``MemSpec``; banked memories own the
    ``BankedLayout`` logical↔physical row math the KV pool and the CUDA
    gather/scatter kernels share.  ``TwoLevelBankedMemory`` is the
    hierarchical O-macro × I-bank shape (no flat layout).
  * ``run_program`` — an ISA program on the SIMT VM, priced on the card;
  * a string-keyed registry: ``get("16B-offset")`` resolves the nine paper
    architectures and parses constructible names (``"32B-xor"``,
    ``"12B"``, ``"8R-1W"``, ``"16B-offset-s2"``, ``"16B-bcast"``,
    ``"4x4B-g64"``) and degraded variants (``"16B-xor!d1+3"``: banks 1
    and 3 offline), which resolve but are never registered.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, replace

import torch

from repro_torch.core import controllers as ctl
from repro_torch.core.bankmap import BANK_MAPS, bank_of
from repro_torch.core.conflicts import max_conflicts, max_conflicts_broadcast
from repro_torch.core.memsim import (LANES, PAPER_MEMORIES, MemSpec,
                                     TraceCost, banked as _banked_spec,
                                     multiport as _multiport_spec,
                                     two_level as _two_level_spec)


# --------------------------------------------------------------------------
# BankedLayout — the one logical↔physical row mapping
# --------------------------------------------------------------------------

def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"bank count must be a power of two, got {n}")
    return n.bit_length() - 1


def bank_slot_of(r, n_banks: int, mapping: str = "lsb", shift: int = 1):
    """Logical row ``r`` (int, numpy array or integer tensor) -> (bank, slot).

    A bijection of ``r`` for every map: the bank is the mapped bits, the
    slot the remaining bits packed densely (the offset map keeps its
    ``shift`` low bits in place).  ``lsb``/``offset`` take any bank count
    through ``//`` and ``%``; ``xor``/``fold`` are power-of-two only."""
    kw = {"shift": shift} if mapping == "offset" else {}
    bank = bank_of(r, n_banks, mapping, **kw)
    if mapping == "offset":
        low = r & ((1 << shift) - 1)
        slot = (((r >> shift) // n_banks) << shift) | low
    elif mapping == "lsb":
        slot = r // n_banks
    else:
        slot = r >> _log2(n_banks)
    return bank, slot


def physical_row_of(r, n_banks: int, rows_per_bank: int,
                    mapping: str = "lsb", shift: int = 1):
    """Logical row -> bank-major physical row ``bank·rows_per_bank + slot``
    (the CUDA kernels carry a ``__device__`` copy of this function)."""
    bank, slot = bank_slot_of(r, n_banks, mapping, shift)
    return bank * rows_per_bank + slot


def logical_row_of(bank, slot, n_banks: int, mapping: str = "lsb",
                   shift: int = 1):
    """Inverse of ``bank_slot_of``: the logical row stored at (bank, slot).
    The paged-KV allocator picks a free (bank, slot) and mints the logical
    page id whose bank map lands exactly there."""
    if mapping == "offset":
        low = slot & ((1 << shift) - 1)
        high = slot >> shift
        return ((high * n_banks + bank) << shift) | low
    if mapping == "lsb":
        return slot * n_banks + bank
    log2b = _log2(n_banks)
    mask = n_banks - 1
    if mapping == "xor":
        lsb = (bank ^ slot) & mask
    elif mapping == "fold":
        lsb = (bank - slot) & mask
    else:
        raise ValueError(
            f"unknown bank map {mapping!r}; choose from {BANK_MAPS}")
    return (slot << log2b) | lsb


@dataclass(frozen=True)
class BankedLayout:
    """Bank-major storage layout: logical row r lives at physical row
    ``bank(r)·rows_per_bank + slot(r)``."""
    n_banks: int
    mapping: str = "lsb"
    shift: int = 1            # offset-map bank-bit position (paper: 1)

    def __post_init__(self):
        if self.n_banks <= 0:
            raise ValueError(f"bank count must be positive, got "
                             f"{self.n_banks}")
        if self.mapping in ("xor", "fold"):
            _log2(self.n_banks)   # bit-mixing maps stay power-of-two
        if self.mapping not in BANK_MAPS:
            raise ValueError(
                f"unknown bank map {self.mapping!r}; choose from {BANK_MAPS}")

    def bank_slot(self, r):
        return bank_slot_of(r, self.n_banks, self.mapping, self.shift)

    def logical_row(self, bank, slot):
        """Inverse of ``bank_slot``: ``logical_row(*bank_slot(r)) == r``."""
        return logical_row_of(bank, slot, self.n_banks, self.mapping,
                              self.shift)

    def physical_row(self, r, n_rows: int):
        return physical_row_of(r, self.n_banks, n_rows // self.n_banks,
                               self.mapping, self.shift)

    def physical_rows(self, n_rows: int, device="cuda") -> torch.Tensor:
        """All logical rows' physical positions: an int64 permutation."""
        if n_rows % self.n_banks:
            raise ValueError(f"n_rows={n_rows} not divisible by "
                             f"{self.n_banks} banks")
        r = torch.arange(n_rows, device=device)
        return self.physical_row(r, n_rows)

    def to_banked(self, table: torch.Tensor) -> torch.Tensor:
        """Relayout logical-row-major -> bank-major."""
        phys = self.physical_rows(table.shape[0], table.device)
        return torch.zeros_like(table).index_copy_(0, phys, table)

    def from_banked(self, table_banked: torch.Tensor) -> torch.Tensor:
        """Inverse relayout bank-major -> logical-row-major."""
        phys = self.physical_rows(table_banked.shape[0], table_banked.device)
        return table_banked[phys]


# --------------------------------------------------------------------------
# MemoryArchitecture hierarchy
# --------------------------------------------------------------------------

class MemoryArchitecture:
    """One shared-memory variant: conflict/cycle model + fmax + costing."""

    def __init__(self, spec: MemSpec):
        self.spec = spec

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def fmax_mhz(self) -> float:
        return self.spec.fmax_mhz

    @property
    def is_banked(self) -> bool:
        return self.spec.is_banked

    @property
    def layout(self) -> BankedLayout | None:
        """Bank-major storage layout; None for layout-free memories."""
        return None

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"

    def op_cycles(self, addrs: torch.Tensor, mask: torch.Tensor | None = None,
                  is_write: bool = False) -> torch.Tensor:
        """(ops, LANES) addresses -> (ops,) cycles each op occupies memory."""
        raise NotImplementedError

    def _instruction_overhead(self, is_write: bool) -> int:
        return 0

    def instruction_cycles(self, addrs: torch.Tensor, is_write: bool = False,
                           mask: torch.Tensor | None = None) -> int:
        """Cycles one memory instruction (a whole (ops, LANES) block) holds
        the pipeline, including the controller overhead."""
        cyc = int(self.op_cycles(addrs, mask, is_write).sum())
        return cyc + self._instruction_overhead(is_write)

    def cost(self, addr_trace, block_ops: int | None = None,
             device="cuda", checked: bool | None = None) -> TraceCost:
        """Cost any trace (``AddressTrace``, ``TraceStream`` or raw block
        iterable) under this architecture: a single-arch call of
        ``cost_engine.cost_many`` (traces above ``STREAM_THRESHOLD`` ops
        stream at ``DEFAULT_BLOCK_OPS``, bit-equal either way).
        ``checked=True`` validates the Trace protocol contracts while
        costing; the default defers to the process-wide ``checking()``
        switch of ``repro_torch.analysis.contracts``."""
        from repro_torch.core.cost_engine import (DEFAULT_BLOCK_OPS,
                                                  STREAM_THRESHOLD, cost_many)
        if block_ops is None:
            n = getattr(addr_trace, "n_ops", None)
            if n is not None and n > STREAM_THRESHOLD:
                block_ops = DEFAULT_BLOCK_OPS
        return cost_many([self], addr_trace, block_ops=block_ops,
                         device=device, checked=checked)[0]

    def _cost_loop(self, addr_trace, device="cuda") -> TraceCost:
        """The per-architecture costing path: one ``op_cycles`` batch and
        one host sync per op kind.  The independent check the engine is
        held to, and the loop baseline ``bench.cost_bench`` times
        ``cost_many`` against."""
        from repro_torch.core import trace as tr
        cost = TraceCost(compute_cycles=int(addr_trace.compute_cycles))
        for kind, is_write, cyc_attr, n_attr in (
                (tr.KIND_LOAD, False, "load_cycles", "n_load_ops"),
                (tr.KIND_TW, False, "tw_load_cycles", "n_tw_ops"),
                (tr.KIND_STORE, True, "store_cycles", "n_store_ops")):
            sub = addr_trace.of_kind(kind)
            if not sub.n_ops:
                continue
            mask = (None if sub.mask is None
                    else torch.from_numpy(sub.mask).to(device))
            cyc = int(self.op_cycles(torch.from_numpy(sub.addrs).to(device),
                                     mask, is_write).sum())
            cyc += sub.n_instructions * self._instruction_overhead(is_write)
            setattr(cost, cyc_attr, cyc)
            setattr(cost, n_attr, sub.n_ops)
        for k in ("fp", "int", "imm", "other"):
            setattr(cost, f"{k}_ops", int(addr_trace.op_counts.get(k, 0)))
        return cost

    def cost_trace(self, load_addrs: list, store_addrs: list,
                   tw_addrs: list | None = None, compute_cycles: int = 0,
                   op_counts: dict | None = None,
                   device="cuda") -> TraceCost:
        """Cost a full program trace given as lists of (ops, LANES)
        address blocks (one instruction per block), priced on ``device``.
        Builds an ``AddressTrace`` and delegates to ``cost``."""
        from repro_torch.core.trace import AddressTrace

        def instr(addrs, kind):      # trace construction is host work
            if isinstance(addrs, torch.Tensor):
                addrs = addrs.cpu().numpy()
            return AddressTrace.from_ops(addrs, kind)
        chunks = ([instr(a, "load") for a in load_addrs]
                  + [instr(a, "store") for a in store_addrs]
                  + [instr(a, "tw") for a in (tw_addrs or [])])
        trace = AddressTrace.concat(*chunks).with_compute(
            compute_cycles, op_counts)
        return self.cost(trace, device=device)

    def run_program(self, program, init_memory=None, execute: bool = True,
                    device="cuda"):
        """Run (and/or cost) an ISA program on this memory (see isa.vm):
        priced on ``device``, executed functionally on the host."""
        import numpy as np

        from repro_torch.isa.assembler import MemLoad, MemStore
        from repro_torch.isa.vm import run_program as _run
        if init_memory is None:
            n_words = 1 + max(
                [int(np.max(i.addrs)) for i in program.instrs
                 if isinstance(i, (MemLoad, MemStore))] or [0])
            init_memory = np.zeros(n_words, np.float32)
        return _run(program, self.spec, init_memory, execute=execute,
                    device=device)

    def time_us(self, cycles: int) -> float:
        return cycles / self.fmax_mhz

    # -- area model --------------------------------------------------------

    def resources(self):
        from repro_torch.core import cost as costmod
        return costmod.memory_resources(self.spec)

    def footprint_alms(self, capacity_kb: float) -> float:
        from repro_torch.core import cost as costmod
        return costmod.footprint_alms(self.spec, capacity_kb)

    def processor_footprint_alms(self, capacity_kb: float) -> float:
        from repro_torch.core import cost as costmod
        return costmod.processor_footprint_alms(self.spec, capacity_kb)


class BankedMemory(MemoryArchitecture):
    """B-bank arbitrated memory (paper §III): per-op cycles = max per-bank
    popcount; reads optionally broadcast-coalesce (beyond-paper)."""

    def __init__(self, n_banks: int = 16, mapping: str = "lsb",
                 shift: int = 1, broadcast: bool = False,
                 spec: MemSpec | None = None):
        if spec is None:
            spec = _banked_spec(n_banks, mapping, shift, broadcast)
        if not spec.is_banked:
            raise ValueError(f"{spec.name} is not a banked spec")
        super().__init__(spec)

    @property
    def n_banks(self) -> int:
        return self.spec.n_banks

    @property
    def mapping(self) -> str:
        return self.spec.mapping

    @property
    def broadcast(self) -> bool:
        return self.spec.broadcast

    @property
    def total_banks(self) -> int:
        """Flat bank count the arbiter sees (inner × outer for two-level)."""
        return self.spec.total_banks

    @property
    def layout(self) -> BankedLayout:
        return BankedLayout(self.n_banks, self.mapping, self.spec.map_shift)

    def banks_of(self, addrs: torch.Tensor) -> torch.Tensor:
        kw = ({"shift": self.spec.map_shift}
              if self.mapping == "offset" else {})
        return bank_of(addrs, self.n_banks, self.mapping, **kw)

    def op_cycles(self, addrs, mask=None, is_write=False):
        banks = self.banks_of(addrs)
        if self.broadcast and not is_write:
            return max_conflicts_broadcast(addrs, banks, self.total_banks,
                                           mask)
        return max_conflicts(banks, self.total_banks, mask)

    def _instruction_overhead(self, is_write: bool) -> int:
        return (ctl.write_overhead(self.total_banks) if is_write
                else ctl.read_overhead(self.total_banks))

    def degrade(self, dead_banks) -> "DegradedBankedMemory":
        """This memory with ``dead_banks`` offline: the variant that prices
        the layout a ``bank_offline`` fault leaves behind."""
        return DegradedBankedMemory(self.spec, dead_banks)


class TwoLevelBankedMemory(BankedMemory):
    """Hierarchical two-level banked memory: ``outer_banks`` memory macros
    × ``n_banks`` inner banks each.

    The outer macro is selected by address granule,
    ``outer = (addr // outer_granule) % outer_banks``, and the inner bank
    by the spec's bank map, so the flat bank id the carry-chain arbiter
    sees is ``inner + n_banks · outer``.  With the default granule
    (``= n_banks``, power of two, lsb map) the composite is a flat
    ``total_banks`` lsb memory.  Named ``{O}x{I}B[-{mapping}][-g{G}]``.

    The flat bank-major ``BankedLayout`` does not apply to a macro
    hierarchy, so ``layout`` is ``None``, as for the multi-port memories.
    """

    def __init__(self, outer: int = 2, inner: int = 8,
                 granule: int | None = None, mapping: str = "lsb",
                 spec: MemSpec | None = None):
        if spec is None:
            spec = _two_level_spec(outer, inner, granule, mapping)
        if not spec.is_two_level:
            raise ValueError(f"{spec.name} is not a two-level spec")
        super().__init__(spec=spec)

    @property
    def outer_banks(self) -> int:
        return self.spec.outer_banks

    @property
    def outer_granule(self) -> int:
        return self.spec.outer_granule

    @property
    def layout(self) -> None:
        return None

    def banks_of(self, addrs: torch.Tensor) -> torch.Tensor:
        addrs = addrs.to(torch.int32)
        inner = super().banks_of(addrs)
        outer = (addrs // self.outer_granule) % self.outer_banks
        return (inner + self.n_banks * outer).to(torch.int32)


def surviving_bank_remap(n_banks: int, dead_banks) -> tuple:
    """The degraded-mode bank remap: each dead bank's requests are served
    by its next surviving neighbor (wrap-around scan); surviving banks map
    to themselves.  Returns a length-``n_banks`` tuple."""
    dead = set(int(d) for d in dead_banks)
    if not all(0 <= d < n_banks for d in dead):
        raise ValueError(f"dead banks {sorted(dead)} out of range for "
                         f"{n_banks} banks")
    if len(dead) >= n_banks:
        raise ValueError(f"cannot offline all {n_banks} banks")
    out = []
    for b in range(n_banks):
        t = b
        while t in dead:
            t = (t + 1) % n_banks
        out.append(t)
    return tuple(out)


class DegradedBankedMemory(BankedMemory):
    """A ``BankedMemory`` with one or more banks offline.

    The logical↔physical row mapping (``layout``) is the healthy base's,
    so page ids and the row kernels' index maps are unchanged, but the
    conflict model remaps every request on a dead bank to its surviving
    neighbor (``surviving_bank_remap``): traffic that spread over B banks
    arbitrates over the survivors.  Named ``{base}!d{b0}+{b1}...`` (e.g.
    ``16B-xor!d3``); ``get`` / ``resolve`` parse the name, but a degraded
    variant is run state, never registered.  Two-level bases degrade over
    their flat bank ids.
    """

    def __init__(self, base_spec: MemSpec, dead_banks=None, *,
                 spec: MemSpec | None = None):
        if spec is None:
            if not base_spec.is_banked:
                raise ValueError(
                    f"{base_spec.name} is not banked; only banked memories "
                    f"degrade (multi-port replicas have no banks to lose)")
            if base_spec.dead_banks:
                dead = tuple(base_spec.dead_banks) + tuple(dead_banks or ())
                base_spec = _base_of(base_spec)
            else:
                dead = tuple(dead_banks or ())
            dead = tuple(sorted(set(int(d) for d in dead)))
            surviving_bank_remap(base_spec.total_banks, dead)  # validates
            if not dead:
                raise ValueError("degraded memory needs >= 1 dead bank")
            spec = replace(
                base_spec, dead_banks=dead,
                name=f"{base_spec.name}!d" + "+".join(str(d) for d in dead))
        if not spec.dead_banks:
            raise ValueError(f"{spec.name} has no dead banks")
        super().__init__(spec=spec)

    @property
    def dead_banks(self) -> tuple:
        return self.spec.dead_banks

    @property
    def base(self) -> BankedMemory:
        """The healthy memory this variant degrades."""
        return from_spec(_base_of(self.spec))

    @property
    def layout(self) -> BankedLayout | None:
        # page ids and kernel index maps are the healthy base's (None for a
        # two-level base, which has no flat bank-major layout)
        return self.base.layout

    def bank_remap(self) -> tuple:
        return surviving_bank_remap(self.total_banks, self.dead_banks)

    def banks_of(self, addrs: torch.Tensor) -> torch.Tensor:
        # the healthy base's map (a two-level base composes inner + outer
        # here), then the surviving-neighbor remap over the flat bank ids
        banks = self.base.banks_of(addrs)
        remap = torch.tensor(self.bank_remap(), dtype=banks.dtype,
                             device=banks.device)
        return remap[banks.long()]


def _base_of(spec: MemSpec) -> MemSpec:
    """A degraded spec's healthy base (identity for healthy specs): the
    dead banks and the ``!d`` name suffix stripped, every other field kept
    (flat, non-pow2 and two-level bases alike)."""
    if not spec.dead_banks:
        return spec
    return replace(spec, dead_banks=(), name=spec.name.split("!d")[0])


class MultiPortMemory(MemoryArchitecture):
    """nR-mW replicated multi-port memory: deterministic ceil(active/ports)
    issue; the -VB variant arbitrates writes over 4 pseudo-banks."""

    def __init__(self, read_ports: int = 4, write_ports: int = 1,
                 vb: bool = False, spec: MemSpec | None = None):
        if spec is None:
            spec = _multiport_spec(read_ports, write_ports, vb)
        if spec.is_banked:
            raise ValueError(f"{spec.name} is not a multi-port spec")
        super().__init__(spec)

    @property
    def read_ports(self) -> int:
        return self.spec.read_ports

    @property
    def write_ports(self) -> int:
        return self.spec.write_ports

    @property
    def vb_write_banks(self) -> int:
        return self.spec.vb_write_banks

    def op_cycles(self, addrs, mask=None, is_write=False):
        if is_write and self.vb_write_banks:
            banks = bank_of(addrs, self.vb_write_banks, "lsb")
            return max_conflicts(banks, self.vb_write_banks, mask)
        ports = self.write_ports if is_write else self.read_ports
        if mask is None:
            active = torch.full((addrs.shape[0],), LANES, dtype=torch.int32,
                                device=addrs.device)
        else:
            active = mask.to(torch.int32).sum(dim=-1, dtype=torch.int32)
        return (active + ports - 1) // ports

    def _instruction_overhead(self, is_write: bool) -> int:
        if is_write and self.vb_write_banks:
            return ctl.write_overhead(self.vb_write_banks)
        return 0


def from_spec(spec: MemSpec) -> MemoryArchitecture:
    """Wrap a frozen MemSpec in its architecture class."""
    if spec.is_banked:
        if spec.dead_banks:
            return DegradedBankedMemory(spec, spec=spec)
        if spec.is_two_level:
            return TwoLevelBankedMemory(spec=spec)
        return BankedMemory(spec=spec)
    return MultiPortMemory(spec=spec)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict[str, MemoryArchitecture] = {}

_BANKED_NAME = re.compile(
    r"^(?P<banks>\d+)B(?:-(?P<mapping>[a-z]+))?(?:-s(?P<shift>\d+))?"
    r"(?P<bcast>-bcast)?$")
_TWO_LEVEL_NAME = re.compile(
    r"^(?P<outer>\d+)x(?P<inner>\d+)B(?:-(?P<mapping>[a-z]+))?"
    r"(?:-g(?P<gran>\d+))?$")
_MULTIPORT_NAME = re.compile(r"^(?P<r>\d+)R-(?P<w>\d+)W(?P<vb>-VB)?$")
_DEGRADED_NAME = re.compile(r"^(?P<base>.+)!d(?P<dead>\d+(?:\+\d+)*)$")


def _map_takes_banks(mapping: str, n_banks: int) -> bool:
    """Modulo maps (lsb/offset) take any positive count, bit-mixing maps
    (xor/fold) need a power of two."""
    if n_banks <= 0:
        return False
    if mapping in ("lsb", "offset"):
        return True
    return n_banks & (n_banks - 1) == 0


def register(arch: MemoryArchitecture,
             name: str | None = None) -> MemoryArchitecture:
    """Register an architecture under its (or an explicit) name."""
    _REGISTRY[name or arch.name] = arch
    return arch


def _parse(name: str) -> MemoryArchitecture | None:
    m = _DEGRADED_NAME.match(name)
    if m:
        base = _parse(m.group("base"))
        if not isinstance(base, BankedMemory) or isinstance(
                base, DegradedBankedMemory):
            return None
        dead = tuple(int(d) for d in m.group("dead").split("+"))
        if any(d >= base.total_banks for d in dead) or len(set(dead)) >= (
                base.total_banks):
            return None
        if list(dead) != sorted(set(dead)):
            return None                 # canonical order so names round-trip
        return DegradedBankedMemory(base.spec, dead)
    m = _BANKED_NAME.match(name)
    if m:
        banks = int(m.group("banks"))
        mapping = m.group("mapping") or "lsb"
        if mapping == "bcast":          # "16B-bcast" (lsb map + broadcast)
            mapping, bcast = "lsb", True
        else:
            bcast = bool(m.group("bcast"))
        if mapping not in BANK_MAPS or not _map_takes_banks(mapping, banks):
            return None
        if m.group("shift") and mapping != "offset":
            return None                 # only the offset map has a shift
        return BankedMemory(banks, mapping, shift=int(m.group("shift") or 1),
                            broadcast=bcast)
    m = _TWO_LEVEL_NAME.match(name)
    if m:
        outer, inner = int(m.group("outer")), int(m.group("inner"))
        mapping = m.group("mapping") or "lsb"
        if outer < 2 or mapping not in BANK_MAPS:
            return None
        if not _map_takes_banks(mapping, inner):
            return None
        gran = int(m.group("gran")) if m.group("gran") else None
        if gran is not None and (gran < 1 or gran == inner):
            # "-g{inner}" is the default granule: the canonical name drops
            # the suffix, so the explicit form must not mint an alias
            return None
        return TwoLevelBankedMemory(outer, inner, gran, mapping)
    m = _MULTIPORT_NAME.match(name)
    if m:
        if not int(m.group("r")) or not int(m.group("w")):
            return None
        return MultiPortMemory(int(m.group("r")), int(m.group("w")),
                               vb=bool(m.group("vb")))
    return None


def get(name: str) -> MemoryArchitecture:
    """Resolve an architecture by name: registered first, then parsed."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    arch = _parse(name)
    if arch is None:
        raise KeyError(
            f"unknown memory architecture {name!r}; registered: "
            f"{sorted(_REGISTRY)}")
    return arch


def names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve(arch) -> MemoryArchitecture:
    """Coerce a name / MemSpec / MemoryArchitecture to an architecture."""
    if isinstance(arch, MemoryArchitecture):
        return arch
    if isinstance(arch, MemSpec):
        return from_spec(arch)
    if isinstance(arch, str):
        return get(arch)
    raise TypeError(f"cannot resolve {arch!r} to a MemoryArchitecture")


#: The nine architectures benchmarked in the paper (Tables II/III).
PAPER_ARCHITECTURES: tuple[MemoryArchitecture, ...] = tuple(
    register(from_spec(s)) for s in PAPER_MEMORIES)

#: Table II uses the 8 memories without the VB variant.
TRANSPOSE_ARCHITECTURES: tuple[MemoryArchitecture, ...] = tuple(
    a for a in PAPER_ARCHITECTURES if a.name != "4R-1W-VB")

#: Beyond-paper lattice points exercising the generalized bank formula:
#: non-power-of-two modulo maps ("12B", "6B-offset") and two-level
#: macro × bank shapes ("4x4B-g64", "2x8B-g32", "4x3B", the last with a
#: non-power-of-two inner level).
EXTENDED_LATTICE_ARCHITECTURES: tuple[MemoryArchitecture, ...] = tuple(
    register(from_spec(s)) for s in (_banked_spec(12, "lsb"),
                                     _banked_spec(6, "offset"),
                                     _two_level_spec(4, 4, granule=64),
                                     _two_level_spec(2, 8, granule=32),
                                     _two_level_spec(4, 3)))
