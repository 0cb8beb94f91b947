"""Static analysis of traces (port of ``repro.analysis``): the streaming
Trace-protocol validator (``validate(trace, arch)``, ``cost_many(...,
checked=True)`` and the process-wide ``checking()`` switch).  The
reference's symbolic prover and lint come with a later slice."""
from repro_torch.analysis.contracts import (TraceContractError,
                                            ValidationReport, checked_blocks,
                                            checking, is_checking,
                                            set_checking, validate)

__all__ = ["validate", "checked_blocks", "ValidationReport",
           "TraceContractError", "checking", "set_checking", "is_checking"]
