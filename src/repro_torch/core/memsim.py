"""Memory descriptors and trace accounting (port of ``repro.core.memsim``).

Two families (paper §I, §III): ``banked`` memories (B banks under a bank
map; per-op cycles = max per-bank popcount), with hierarchical two-level
shapes (``two_level``: O macros × I banks), and replicated ``multiport``
memories (nR-mW; the 4R-1W-VB variant arbitrates writes over 4
pseudo-banks).  fmax: 771 MHz for every memory except 4R-2W (600 MHz).

Degraded (bank-offline) memories carry their dead banks in
``MemSpec.dead_banks``; ``repro_torch.core.arch`` prices them.
``op_conflict_cycles``, ``instruction_cycles`` and ``cost_trace`` are the
reference's spec-level entry points, delegating to the architecture
classes; ``Memory`` is the functional word memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

LANES = 16  # the eGPU issues 16 requests per clock (one warp)

FMAX_DEFAULT_MHZ = 771.0
FMAX_4R2W_MHZ = 600.0


@dataclass(frozen=True)
class MemSpec:
    """Architecture descriptor for one shared-memory variant."""
    kind: Literal["banked", "multiport"]
    name: str
    # banked:
    n_banks: int = 16
    mapping: str = "lsb"
    map_shift: int = 1
    broadcast: bool = False   # beyond-paper: same-address read coalescing
    # multiport:
    read_ports: int = 4
    write_ports: int = 1
    vb_write_banks: int = 0   # 4R-1W-VB: writes arbitrated over N pseudo-banks
    fmax_mhz: float = FMAX_DEFAULT_MHZ
    #: offline banks of a degraded banked memory (``repro_torch.core.arch``'s
    #: ``!d`` variants): a request whose bank map lands on a dead bank is
    #: served by its next surviving neighbor (wrap-around remap).  Always
    #: ``()`` for healthy memories; the cost engine's lowering takes the
    #: remap path only when a spec carries dead banks.
    dead_banks: tuple = ()
    #: hierarchical two-level banking: ``outer_banks`` memory macros, each
    #: holding ``n_banks`` inner banks.  The outer level is selected by
    #: address granule, ``outer = (addr // outer_granule) % outer_banks``;
    #: the inner level applies ``mapping``.  The flat bank id the arbiter
    #: sees is ``inner + n_banks * outer``.  ``0`` on both fields means a
    #: single-level memory (the default everywhere).
    outer_banks: int = 0
    outer_granule: int = 0

    @property
    def is_banked(self) -> bool:
        return self.kind == "banked"

    @property
    def is_two_level(self) -> bool:
        return self.kind == "banked" and self.outer_banks > 1

    @property
    def total_banks(self) -> int:
        """Flat bank count the arbiter sees: inner × outer levels."""
        if self.kind != "banked":
            return 0
        return self.n_banks * max(1, self.outer_banks)


def banked(n_banks: int, mapping: str = "lsb", shift: int = 1,
           broadcast: bool = False) -> MemSpec:
    """A banked memory spec.  Names: ``{B}B[-map][-s{K}][-bcast]`` (the
    shift suffix only for offset maps off the calibrated shift 1)."""
    suffix = "" if mapping == "lsb" else f"-{mapping}"
    if mapping == "offset" and shift != 1:
        suffix += f"-s{shift}"
    if broadcast:
        suffix += "-bcast"
    return MemSpec(kind="banked", name=f"{n_banks}B{suffix}", n_banks=n_banks,
                   mapping=mapping, map_shift=shift, broadcast=broadcast)


def two_level(outer: int, inner: int, granule: int | None = None,
              mapping: str = "lsb") -> MemSpec:
    """Hierarchical two-level banked memory: ``outer`` macros × ``inner``
    banks each.  ``granule`` is the address run (in words) that stays in
    one macro before the outer map rotates; the default ``inner`` makes a
    power-of-two lsb composite identical to a flat ``outer*inner``-bank
    lsb memory.  Names: ``{O}x{I}B[-{mapping}][-g{G}]`` (the granule
    suffix only off the default)."""
    if granule is None:
        granule = inner
    if outer < 2:
        raise ValueError("two_level needs outer >= 2 (use banked() otherwise)")
    if granule < 1:
        raise ValueError("outer_granule must be >= 1")
    suffix = "" if mapping == "lsb" else f"-{mapping}"
    if granule != inner:
        suffix += f"-g{granule}"
    return MemSpec(kind="banked", name=f"{outer}x{inner}B{suffix}",
                   n_banks=inner, mapping=mapping,
                   outer_banks=outer, outer_granule=granule)


def multiport(read_ports: int, write_ports: int, vb: bool = False) -> MemSpec:
    name = f"{read_ports}R-{write_ports}W" + ("-VB" if vb else "")
    fmax = FMAX_4R2W_MHZ if (write_ports == 2 and not vb) else FMAX_DEFAULT_MHZ
    return MemSpec(kind="multiport", name=name, read_ports=read_ports,
                   write_ports=write_ports, vb_write_banks=4 if vb else 0,
                   fmax_mhz=fmax)


#: The nine architectures benchmarked in the paper (Tables II/III).
PAPER_MEMORIES: tuple[MemSpec, ...] = (
    multiport(4, 1),
    multiport(4, 2),
    multiport(4, 1, vb=True),
    banked(16, "lsb"),
    banked(16, "offset"),
    banked(8, "lsb"),
    banked(8, "offset"),
    banked(4, "lsb"),
    banked(4, "offset"),
)

#: Table II uses the 8 memories without the VB variant.
TRANSPOSE_MEMORIES: tuple[MemSpec, ...] = tuple(
    m for m in PAPER_MEMORIES if m.name != "4R-1W-VB"
)


# --------------------------------------------------------------------------
# Timing: spec-level entry points delegating to the MemoryArchitecture
# classes (``repro_torch.core.arch`` owns the conflict and cycle model; the
# preferred entry point is ``arch.cost(AddressTrace)``)
# --------------------------------------------------------------------------

def op_conflict_cycles(spec: MemSpec, addrs: torch.Tensor,
                       mask: torch.Tensor | None = None,
                       is_write: bool = False) -> torch.Tensor:
    """(ops, LANES) addresses -> (ops,) cycles each operation occupies
    memory.  Multi-port memories cost only the active lanes under ``mask``
    (ceil(active/ports) per op); banked memories arbitrate active lanes
    only."""
    from repro_torch.core import arch as _arch
    return _arch.from_spec(spec).op_cycles(addrs, mask=mask,
                                           is_write=is_write)


def instruction_cycles(spec: MemSpec, addrs: torch.Tensor, is_write: bool,
                       mask: torch.Tensor | None = None) -> int:
    """Cycles one memory instruction (a whole (ops, LANES) block) occupies,
    with the per-instruction pipeline overhead of banked memories (the
    multi-port memories' round-robin controller adds none)."""
    from repro_torch.core import arch as _arch
    return _arch.from_spec(spec).instruction_cycles(addrs, is_write=is_write,
                                                    mask=mask)


# --------------------------------------------------------------------------
# Functional memory
# --------------------------------------------------------------------------

@dataclass
class Memory:
    """Flat 32-bit word memory with float32 view semantics: data is stored
    as float32 words (the paper's benchmarks are FP32 FFT data and
    word-sized matrix elements).  Writes return a new ``Memory``."""
    words: torch.Tensor  # (n_words,) float32

    @staticmethod
    def zeros(n_words: int, device="cuda") -> "Memory":
        return Memory(torch.zeros((n_words,), dtype=torch.float32,
                                  device=device))

    def _index(self, addrs) -> torch.Tensor:
        return torch.as_tensor(addrs, device=self.words.device).to(
            torch.int64)

    def read(self, addrs) -> torch.Tensor:
        return self.words[self._index(addrs)]

    def write(self, addrs, values,
              mask: torch.Tensor | None = None) -> "Memory":
        """Store ``values`` at ``addrs`` (negative addresses count from the
        end, as in the reference); a lane whose ``mask`` is false, or whose
        address lies outside the memory, writes nothing."""
        n = self.words.shape[0]
        a = self._index(addrs).reshape(-1)
        v = torch.as_tensor(values, dtype=torch.float32,
                            device=self.words.device).reshape(-1)
        a = torch.where(a < 0, a + n, a)
        keep = (a >= 0) & (a < n)
        if mask is not None:
            keep = keep & torch.as_tensor(
                mask, device=self.words.device).to(torch.bool).reshape(-1)
        words = self.words.clone()
        words[a[keep]] = v[keep]
        return Memory(words)


# --------------------------------------------------------------------------
# Trace accounting
# --------------------------------------------------------------------------

@dataclass
class TraceCost:
    """Accumulated cycle cost of a trace under one memory spec."""
    load_cycles: int = 0
    store_cycles: int = 0
    tw_load_cycles: int = 0      # twiddle loads reported separately (Table III)
    compute_cycles: int = 0      # FP + INT + Immediate + Other instruction cycles
    n_load_ops: int = 0
    n_store_ops: int = 0
    n_tw_ops: int = 0
    fp_ops: int = 0
    int_ops: int = 0
    imm_ops: int = 0
    other_ops: int = 0

    @property
    def total_cycles(self) -> int:
        return (self.compute_cycles + self.load_cycles + self.store_cycles
                + self.tw_load_cycles)

    def time_us(self, fmax_mhz: float) -> float:
        return self.total_cycles / fmax_mhz

    def read_bank_eff(self) -> float:
        denom = self.load_cycles
        return 100.0 * self.n_load_ops / denom if denom else float("nan")

    def tw_bank_eff(self) -> float:
        denom = self.tw_load_cycles
        return 100.0 * self.n_tw_ops / denom if denom else float("nan")

    def write_bank_eff(self) -> float:
        denom = self.store_cycles
        return 100.0 * self.n_store_ops / denom if denom else float("nan")


def cost_trace(spec: MemSpec, load_addrs: list, store_addrs: list,
               tw_addrs: list | None = None, compute_cycles: int = 0,
               op_counts: dict | None = None, device="cuda") -> TraceCost:
    """Cost a full program trace given as lists of per-instruction (ops,
    LANES) address blocks, priced on ``device``.  Delegates to
    ``MemoryArchitecture.cost_trace``, which lowers the lists to one
    ``AddressTrace`` and prices it with ``arch.cost``: build the
    ``AddressTrace`` directly in new code."""
    from repro_torch.core import arch as _arch
    return _arch.from_spec(spec).cost_trace(
        load_addrs, store_addrs, tw_addrs=tw_addrs,
        compute_cycles=compute_cycles, op_counts=op_counts, device=device)
