"""Area / footprint cost model (paper §IV, Table I, Fig 8-9; port of
``repro.core.cost``).

The paper's "true cost" methodology: memories are node-locked to sectors;
the footprint is expressed in **sector equivalents** (1 Agilex sector =
16,640 ALMs, ~228 M20K columns-worth).  Key calibrated facts:

  * 16-bank shared memory (max 448 KB) = 1 sector; 8-bank = 1/2; 4-bank =
    1/4 — constant in capacity (the arbiters/muxes dominate, not the
    M20Ks).
  * Multi-port memories replicate data: 4R-1W = 4 physical copies (caps at
    112 KB logical / sector), 4R-2W (quad-port M20K mode) = 2 copies (caps
    at 224 KB), plus pipelining ALMs that grow linearly beyond a 64 KB
    physical footprint (paper §IV.A assumption, stated verbatim).
  * M20K = 2 KB usable in 512×32 mode; fmax 771 MHz (600 MHz for 4R-2W).

Table I resource counts are embedded verbatim for the area benchmark.  The
model is host arithmetic on ``MemSpec``: no tensor is involved.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.memsim import MemSpec

SECTOR_ALMS = 16640
SECTOR_M20KS = 228          # ~70 ALMs per M20K ratio (paper: "about 70")
M20K_KBYTES = 2.0           # 512 x 32b mode
MAX_BANKED_KB = 448.0       # 16-bank sector-locked maximum

# --- Table I (verbatim): per-module resources -------------------------------
# (module, count, ALMs, Regs, M20K, DSP)
TABLE_I = {
    "common": [
        ("SP", 16, 430, 1100, 2, 2),
        ("Fetch/Decode", 1, 233, 508, 2, 0),
    ],
    "banked4": [
        ("Read Ctl.", 1, 342, 1105, 6, 0),
        ("Write Ctl.", 1, 811, 3114, 19, 0),
        ("Shared Mem.", 1, 3225, 10389, 26, 0),
        ("Read Arb.", 4, 135, 372, 0, 0),
        ("Write Arb.", 4, 441, 1166, 0, 0),
        ("Output Mux", 16, 40, 118, 0, 0),
    ],
    "banked8": [
        ("Read Ctl.", 1, 511, 1595, 7, 0),
        ("Write Ctl.", 1, 1094, 4072, 19, 0),
        ("Shared Mem.", 1, 6526, 20324, 64, 0),
        ("Read Arb.", 8, 145, 384, 0, 0),
        ("Write Arb.", 8, 448, 1165, 0, 0),
        ("Output Mux", 16, 80, 188, 0, 0),
    ],
    "banked16": [
        ("Read Ctl.", 1, 789, 2151, 7, 0),
        ("Write Ctl.", 1, 1507, 5245, 20, 0),
        ("Shared Mem.", 1, 13105, 39805, 128, 0),
        ("Read Arb.", 16, 138, 369, 0, 0),
        ("Write Arb.", 16, 438, 1164, 0, 0),
        ("Output Mux", 16, 173, 353, 0, 0),
    ],
    "multiport": [
        ("R/W Control", 1, 700, 795, 0, 0),
        ("4R-1W Shared Mem.", 1, 131, 237, 64, 0),
    ],
}


@dataclass(frozen=True)
class Resources:
    alms: int = 0
    regs: int = 0
    m20k: int = 0
    dsp: int = 0

    def __add__(self, o: "Resources") -> "Resources":
        return Resources(self.alms + o.alms, self.regs + o.regs,
                         self.m20k + o.m20k, self.dsp + o.dsp)

    def scaled(self, k: int) -> "Resources":
        return Resources(self.alms * k, self.regs * k, self.m20k * k,
                         self.dsp * k)


def _sum_rows(rows) -> Resources:
    tot = Resources()
    for (_, n, alms, regs, m20k, dsp) in rows:
        tot = tot + Resources(alms, regs, m20k, dsp).scaled(n)
    return tot


def core_resources() -> Resources:
    """16 SPs + fetch/decode (the 'Common' block of Table I)."""
    return _sum_rows(TABLE_I["common"])


def memory_resources(spec: MemSpec) -> Resources:
    """Table-I resource count for one memory variant (shared mem + ctls)."""
    if spec.is_banked:
        return _sum_rows(TABLE_I[f"banked{spec.n_banks}"])
    return _sum_rows(TABLE_I["multiport"])


def replication_factor(spec: MemSpec) -> int:
    """Physical copies of the data a memory variant needs."""
    if spec.is_banked:
        return 1
    if spec.write_ports >= 2:
        return 2  # quad-port M20K mode (4R-2W)
    return spec.read_ports  # pure replication (4R-1W, 4R-1W-VB)


def max_capacity_kb(spec: MemSpec) -> float:
    """Largest logical capacity that fits one sector (paper Fig 9
    roofline)."""
    return MAX_BANKED_KB / replication_factor(spec)


def pipelining_alms(physical_kb: float) -> float:
    """Paper §IV.A: no extra logic up to 64 KB physical; linear growth up to
    a full sector (448 KB), where 'considerable pipelining' is needed.  The
    full-sector endpoint is modelled as 2,000 ALMs (an assumption)."""
    if physical_kb <= 64.0:
        return 0.0
    return 2000.0 * min(1.0, (physical_kb - 64.0) / (MAX_BANKED_KB - 64.0))


def footprint_alms(spec: MemSpec, capacity_kb: float) -> float:
    """True-footprint area (ALM equivalents) of the *memory subsystem* for
    a given logical capacity, per the paper's sector-equivalent
    methodology."""
    if spec.is_banked:
        # constant: 16-bank = 1 sector, 8 = 1/2, 4 = 1/4 (paper §IV.A)
        if capacity_kb > MAX_BANKED_KB:
            raise ValueError(f"banked memory caps at {MAX_BANKED_KB} "
                             f"KB/sector")
        return SECTOR_ALMS * (spec.n_banks / 16.0)
    physical_kb = capacity_kb * replication_factor(spec)
    if physical_kb > MAX_BANKED_KB:
        raise ValueError(
            f"{spec.name} caps at {max_capacity_kb(spec):.0f} KB logical")
    m20k_area = (physical_kb / M20K_KBYTES) / SECTOR_M20KS * SECTOR_ALMS
    logic = _sum_rows(TABLE_I["multiport"]).alms + pipelining_alms(physical_kb)
    # footprint = M20K span area, plus control/pipelining logic
    return m20k_area + logic


def area_time_score(spec: MemSpec, capacity_kb: float,
                    time_us: float) -> float:
    """Fig 9-style cost×performance objective for ``repro_torch.tune``:
    whole-processor footprint (sector-equivalent ALMs) × runtime.  Lower is
    better; architectures whose replicated data can't fit the capacity at
    all score ``inf`` (they're not a design point, per the paper's
    "effective footprint cost ... quickly becomes prohibitive")."""
    try:
        return processor_footprint_alms(spec, capacity_kb) * time_us
    except ValueError:
        return float("inf")


def processor_footprint_alms(spec: MemSpec, capacity_kb: float) -> float:
    """Whole-processor footprint: memory subsystem + SPs/fetch/decode +
    access controllers (unconstrained placement, ALM-dominated)."""
    ctl = Resources()
    if spec.is_banked:
        rows = TABLE_I[f"banked{spec.n_banks}"]
        ctl = _sum_rows([r for r in rows if "Ctl" in r[0]])
    return footprint_alms(spec, capacity_kb) + core_resources().alms + ctl.alms
