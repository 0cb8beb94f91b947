"""The paper's own processor configuration — the eGPU SIMT core the banked
memories attach to (port of ``repro.configs.paper_simt``: not an LM
architecture; consumed by the simulator and benchmarks rather than the
serving path)."""
from dataclasses import dataclass

from repro_torch.core.memsim import PAPER_MEMORIES, MemSpec, banked


@dataclass(frozen=True)
class SimtConfig:
    lanes: int = 16                   # SPs per core (warp = 16)
    max_threads: int = 4096           # thread-block capability
    threads_per_block: int = 1024     # benchmarks' working block size
    fmax_mhz: float = 771.0           # DSP-limited FP32 clock
    word_bits: int = 32
    shared_memory: MemSpec = banked(16)
    shared_kb: float = 448.0          # sector-locked maximum


CONFIG = SimtConfig()

#: Table I/II/III variants (the 9 memory architectures).
MEMORY_VARIANTS = PAPER_MEMORIES
