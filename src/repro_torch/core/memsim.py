"""Memory descriptors and trace accounting (port of ``repro.core.memsim``).

Two families (paper §I, §III): ``banked`` memories (B banks under a bank
map; per-op cycles = max per-bank popcount) and replicated ``multiport``
memories (nR-mW; the 4R-1W-VB variant arbitrates writes over 4
pseudo-banks).  fmax: 771 MHz for every memory except 4R-2W (600 MHz).

The functional ``Memory`` and the hierarchical two-level and degraded
variants are not ported yet (the ISA and fault slices bring them).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

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

    @property
    def is_banked(self) -> bool:
        return self.kind == "banked"


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
