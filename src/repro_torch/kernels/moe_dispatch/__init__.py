from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                  moe_dispatch_positions,
                                                  moe_dispatch_symbolic,
                                                  moe_dispatch_trace,
                                                  moe_dispatch_trace_blocks)
from repro_torch.kernels.moe_dispatch.ref import moe_dispatch_ref
from repro_torch.kernels.registry import Kernel, register

register(Kernel(
    name="moe_dispatch",
    cuda=lambda arch, experts, n_experts, capacity: moe_dispatch_positions(
        experts, n_experts, capacity),
    ref=lambda arch, experts, n_experts, capacity, **_: moe_dispatch_ref(
        experts, n_experts, capacity),
    trace=moe_dispatch_trace,
    blocks=moe_dispatch_trace_blocks,
    symbolic=moe_dispatch_symbolic,
    description="running-count MoE token dispatch (arbiter math at scale)",
))

__all__ = ["moe_dispatch_positions", "moe_dispatch_plain"]
