from repro_torch.kernels.banked_transpose.ops import (
    banked_transpose, banked_transpose_symbolic, banked_transpose_trace,
    banked_transpose_trace_blocks)
from repro_torch.kernels.banked_transpose.ref import banked_transpose_ref
from repro_torch.kernels.registry import Kernel, register

# The transpose does not depend on the bank map (the reference ignores
# ``arch`` too): every memory, multi-port ones included, runs the kernel on
# a CUDA tensor and the plain version on a CPU one.
register(Kernel(
    name="banked_transpose",
    cuda=lambda arch, x, **_: banked_transpose(x),
    ref=lambda arch, x, **_: banked_transpose_ref(x),
    trace=banked_transpose_trace,
    blocks=banked_transpose_trace_blocks,
    symbolic=banked_transpose_symbolic,
    description="shared-memory tiled matrix transpose (paper Table II "
                "workload)",
))

__all__ = ["banked_transpose", "banked_transpose_ref"]
