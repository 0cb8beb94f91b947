import numpy as np
import torch

from repro_torch.kernels.fft_stage.ops import (fft4096_radix4, fft_stage,
                                               fft_stage_radix4, fft_symbolic,
                                               fft_trace, fft_trace_blocks)
from repro_torch.kernels.fft_stage.ref import (fft_oracle_digit_reversed,
                                               fft_radix4_ref, fft_stage_ref)
from repro_torch.kernels.registry import Kernel, register


def _ref(arch, x, **_):
    """The numpy oracle of every row's digit-reversed spectrum."""
    flat = np.asarray(x.cpu()).reshape(-1, x.shape[-1])
    out = np.stack([fft_oracle_digit_reversed(row) for row in flat])
    return torch.from_numpy(out.reshape(x.shape)).to(x.device)


# The passes do not depend on the bank map (the reference ignores ``arch``
# too): every memory, multi-port ones included, runs the kernel on a CUDA
# tensor and the plain version on a CPU one.
register(Kernel(
    name="fft_stage",
    cuda=lambda arch, x, **_: fft4096_radix4(x, n=x.shape[-1]),
    ref=_ref,
    trace=fft_trace,
    blocks=fft_trace_blocks,
    symbolic=fft_symbolic,
    description="radix-4 DIF FFT passes (paper Table III workload)",
))

__all__ = ["fft4096_radix4", "fft_stage", "fft_stage_radix4",
           "fft_stage_ref", "fft_radix4_ref"]
