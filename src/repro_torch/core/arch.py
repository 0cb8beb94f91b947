"""Memory-architecture API (port of ``repro.core.arch``).

  * ``MemoryArchitecture`` — one shared-memory variant: conflict/cycle
    model, fmax and trace costing (``cost`` over the batched engine).
  * ``BankedMemory`` / ``MultiPortMemory`` — the two families of paper
    §I/§III, wrapping a frozen ``MemSpec``; banked memories own the
    ``BankedLayout`` logical↔physical row math the KV pool and the CUDA
    gather/scatter kernels share.
  * a string-keyed registry: ``get("16B-offset")`` resolves the nine paper
    architectures and parses constructible names (``"32B-xor"``,
    ``"12B"``, ``"8R-1W"``, ``"16B-offset-s2"``, ``"16B-bcast"``).

Two-level (``{O}x{I}B``) and degraded (``...!d{b}``) names parse to
``NotImplementedError``: those variants come with a later slice, and a name
that would be mispriced is refused instead.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import torch

from repro_torch.core import controllers as ctl
from repro_torch.core.bankmap import BANK_MAPS, bank_of
from repro_torch.core.conflicts import max_conflicts, max_conflicts_broadcast
from repro_torch.core.memsim import (LANES, PAPER_MEMORIES, MemSpec,
                                     TraceCost, banked as _banked_spec,
                                     multiport as _multiport_spec)


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
             device="cuda") -> TraceCost:
        """Cost any trace (``AddressTrace``, ``TraceStream`` or raw block
        iterable) under this architecture: a single-arch call of
        ``cost_engine.cost_many`` (traces above ``STREAM_THRESHOLD`` ops
        stream at ``DEFAULT_BLOCK_OPS``, bit-equal either way)."""
        from repro_torch.core.cost_engine import (DEFAULT_BLOCK_OPS,
                                                  STREAM_THRESHOLD, cost_many)
        if block_ops is None:
            n = getattr(addr_trace, "n_ops", None)
            if n is not None and n > STREAM_THRESHOLD:
                block_ops = DEFAULT_BLOCK_OPS
        return cost_many([self], addr_trace, block_ops=block_ops,
                         device=device)[0]


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
    def layout(self) -> BankedLayout:
        return BankedLayout(self.n_banks, self.mapping, self.spec.map_shift)

    def banks_of(self, addrs: torch.Tensor) -> torch.Tensor:
        kw = ({"shift": self.spec.map_shift}
              if self.mapping == "offset" else {})
        return bank_of(addrs, self.n_banks, self.mapping, **kw)

    def op_cycles(self, addrs, mask=None, is_write=False):
        banks = self.banks_of(addrs)
        if self.broadcast and not is_write:
            return max_conflicts_broadcast(addrs, banks, self.n_banks, mask)
        return max_conflicts(banks, self.n_banks, mask)

    def _instruction_overhead(self, is_write: bool) -> int:
        return (ctl.write_overhead(self.n_banks) if is_write
                else ctl.read_overhead(self.n_banks))


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
    if _DEGRADED_NAME.match(name):
        raise NotImplementedError(
            f"{name!r} is a degraded (bank-offline) variant; the port "
            f"brings degraded memories with the fault-tolerance slice")
    if _TWO_LEVEL_NAME.match(name):
        raise NotImplementedError(
            f"{name!r} is a two-level banked memory; the port brings "
            f"two-level memories with the trace-cost slice")
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

#: Beyond-paper non-power-of-two lattice points (the two-level points of
#: the reference lattice come with the two-level slice).
EXTENDED_LATTICE_ARCHITECTURES: tuple[MemoryArchitecture, ...] = tuple(
    register(from_spec(s)) for s in (_banked_spec(12, "lsb"),
                                     _banked_spec(6, "offset")))
