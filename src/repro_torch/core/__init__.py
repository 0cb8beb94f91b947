"""The paper's contribution as a timing model on torch: bank maps, conflict
counting, the carry-chain arbiter, the memory architectures, the area
model, address traces and the batched cost engine (port of
``repro.core``)."""
from repro_torch.core import arch, cost, cost_engine
from repro_torch.core.arch import (PAPER_ARCHITECTURES,
                                   TRANSPOSE_ARCHITECTURES, BankedLayout,
                                   BankedMemory, MemoryArchitecture,
                                   MultiPortMemory)
from repro_torch.core.cost_engine import cost_many, lower_archs
from repro_torch.core.dispatch import (DispatchPlan, banked_dispatch,
                                       gather_from_banks, scatter_to_banks,
                                       serialization_factor)
from repro_torch.core.memsim import (LANES, PAPER_MEMORIES,
                                     TRANSPOSE_MEMORIES, MemSpec, TraceCost)
from repro_torch.core.trace import AddressTrace, TraceStream

__all__ = ["arch", "cost", "cost_engine", "PAPER_ARCHITECTURES",
           "TRANSPOSE_ARCHITECTURES", "BankedLayout",
           "BankedMemory", "MemoryArchitecture", "MultiPortMemory",
           "cost_many", "lower_archs", "DispatchPlan", "banked_dispatch",
           "gather_from_banks", "scatter_to_banks", "serialization_factor",
           "LANES", "PAPER_MEMORIES", "TRANSPOSE_MEMORIES", "MemSpec",
           "TraceCost", "AddressTrace", "TraceStream"]
