"""The paper's contribution as a timing model on torch: bank maps, conflict
counting, the carry-chain arbiter, the dispatch bridge, the memory
architectures, the area model, address traces and the batched cost engine
(port of ``repro.core``, whose ``__all__`` this one equals)."""
from repro_torch.core.bankmap import BANK_MAPS, bank_of, get_bank_map
from repro_torch.core.conflicts import (bank_counts, bank_efficiency,
                                        bank_onehot, imbalance_factor,
                                        max_conflicts, op_cycles_from_addrs)
from repro_torch.core.arbiter import (arbitrate_schedule, arbiter_step,
                                      grant_positions, output_mux_controls,
                                      pack_requests, unpack_grants)
from repro_torch.core.dispatch import (DispatchPlan, banked_dispatch,
                                       gather_from_banks, scatter_to_banks,
                                       serialization_factor)
from repro_torch.core.memsim import (LANES, PAPER_MEMORIES,
                                     TRANSPOSE_MEMORIES, MemSpec, Memory,
                                     TraceCost, banked, cost_trace,
                                     instruction_cycles, multiport,
                                     op_conflict_cycles)
from repro_torch.core import arch, cost, cost_engine
from repro_torch.core.arch import (PAPER_ARCHITECTURES,
                                   TRANSPOSE_ARCHITECTURES, BankedLayout,
                                   BankedMemory, MemoryArchitecture,
                                   MultiPortMemory)
from repro_torch.core.cost_engine import cost_many, lower_archs
from repro_torch.core.trace import AddressTrace, TraceStream

__all__ = [
    "BANK_MAPS", "bank_of", "get_bank_map",
    "bank_counts", "bank_efficiency", "bank_onehot", "imbalance_factor",
    "max_conflicts", "op_cycles_from_addrs",
    "arbitrate_schedule", "arbiter_step", "grant_positions",
    "output_mux_controls", "pack_requests", "unpack_grants",
    "DispatchPlan", "banked_dispatch", "gather_from_banks",
    "scatter_to_banks", "serialization_factor",
    "LANES", "PAPER_MEMORIES", "TRANSPOSE_MEMORIES", "MemSpec", "Memory",
    "TraceCost", "banked", "cost_trace", "instruction_cycles", "multiport",
    "op_conflict_cycles", "cost",
    "arch", "MemoryArchitecture", "BankedMemory", "MultiPortMemory",
    "BankedLayout", "PAPER_ARCHITECTURES", "TRANSPOSE_ARCHITECTURES",
    "cost_engine", "cost_many", "lower_archs", "AddressTrace", "TraceStream",
]
