"""Fault plans and fault-tolerance primitives (port of ``repro.runtime``):
seeded ``FaultPlan`` timelines the serving scheduler replays, and the
``retry_step`` / ``StepWatchdog`` / ``PreemptionGuard`` primitives.  The
reference's ``elastic_restore`` and ``make_current_mesh`` are not ported.
"""
from repro_torch.runtime.fault_tolerance import (PreemptionGuard,
                                                 StepWatchdog, retry_step)
from repro_torch.runtime.faults import (FAULT_KINDS, FaultEvent, FaultPlan,
                                        TransientFault)

__all__ = ["PreemptionGuard", "StepWatchdog", "retry_step",
           "FAULT_KINDS", "FaultEvent", "FaultPlan", "TransientFault"]
