from repro_torch.kernels.carry_arbiter.ops import (carry_arbiter,
                                                   carry_arbiter_plain,
                                                   carry_arbiter_symbolic,
                                                   carry_arbiter_trace,
                                                   carry_arbiter_trace_blocks)
from repro_torch.kernels.carry_arbiter.ref import carry_arbiter_ref
from repro_torch.kernels.registry import Kernel, register

register(Kernel(
    name="carry_arbiter",
    cuda=lambda arch, requests: carry_arbiter(requests),
    ref=lambda arch, requests, **_: carry_arbiter_ref(requests),
    trace=carry_arbiter_trace,
    blocks=carry_arbiter_trace_blocks,
    symbolic=carry_arbiter_symbolic,
    description="carry-chain arbiter grant-schedule generator (paper Fig 4)",
))

__all__ = ["carry_arbiter", "carry_arbiter_plain"]
