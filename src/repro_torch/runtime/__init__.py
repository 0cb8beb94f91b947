"""Fault plans and fault-tolerance primitives (port of ``repro.runtime``):
seeded ``FaultPlan`` timelines the serving scheduler replays, the
``retry_step`` / ``StepWatchdog`` / ``PreemptionGuard`` primitives, and
``make_current_mesh`` / ``elastic_restore``.
"""
from repro_torch.runtime.elastic import elastic_restore, make_current_mesh
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StepWatchdog, retry_step)
from repro_torch.runtime.faults import (FAULT_KINDS, FaultEvent, FaultPlan,
                                        TransientFault)

__all__ = ["PreemptionGuard", "StepWatchdog", "retry_step",
           "FAULT_KINDS", "FaultEvent", "FaultPlan", "TransientFault",
           "elastic_restore", "make_current_mesh"]
