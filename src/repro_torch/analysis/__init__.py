"""Static analysis of traces (port of ``repro.analysis``): three passes
that make the cost engine one of two independent oracles.

  * ``repro_torch.analysis.contracts`` — the streaming Trace-protocol
    validator (``validate(trace, arch)``, ``cost_many(...,
    checked=True)`` and the process-wide ``checking()`` switch).
  * ``repro_torch.analysis.symbolic`` — the symbolic bank-conflict
    prover: kernels and ISA programs describe their address streams as
    affine lane families; ``prove(arch, symbolic)`` derives
    per-instruction max-conflict bounds and full ``TraceCost``s on the
    host, and ``cross_check`` holds them bit for bit to ``cost_many`` on
    the card (or on the host with ``device="cpu"``).
  * ``repro_torch.analysis.lint`` — the reference's AST lint over
    ``src/`` and the registry checks, read against the port's registry.

``python -m repro_torch.analysis [--lint PATH...] [--prove] [--check]
[--device cuda|cpu]`` runs them (all three without a pass flag)."""
from repro_torch.analysis.contracts import (TraceContractError,
                                            ValidationReport, checked_blocks,
                                            checking, is_checking,
                                            set_checking, validate)

__all__ = ["validate", "checked_blocks", "ValidationReport",
           "TraceContractError", "checking", "set_checking", "is_checking"]
