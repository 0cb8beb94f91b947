"""The radix-4 DIF pass and the whole transform in plain PyTorch (the CPU
path of the wrappers, and the versions the CUDA kernel is held to on the
card), plus the numpy oracle of the digit-reversed spectrum."""
from __future__ import annotations

import numpy as np
import torch


def fft_stage_ref(xr: torch.Tensor, xi: torch.Tensor, twr: torch.Tensor,
                  twi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass on (rows, 4, sub) f32 planes with (1, 4, sub) twiddles:
    the reference kernel's ±1/±j butterfly and twiddle multiply, operation
    for operation, into new planes."""
    x0r, x1r, x2r, x3r = (xr[:, k] for k in range(4))
    x0i, x1i, x2i, x3i = (xi[:, k] for k in range(4))
    a_r, a_i = x0r + x2r, x0i + x2i              # x0 + x2
    b_r, b_i = x0r - x2r, x0i - x2i              # x0 - x2
    c_r, c_i = x1r + x3r, x1i + x3i              # x1 + x3
    d_r, d_i = x1r - x3r, x1i - x3i              # x1 - x3
    ys_r = torch.stack([a_r + c_r, b_r + d_i, a_r - c_r, b_r - d_i], dim=1)
    ys_i = torch.stack([a_i + c_i, b_i - d_r, a_i - c_i, b_i + d_r], dim=1)
    return ys_r * twr - ys_i * twi, ys_r * twi + ys_i * twr


def fft_radix4_ref(x: torch.Tensor, n: int = 4096) -> torch.Tensor:
    """(batch, n) complex64 -> digit-reversed spectrum: the log4 n passes
    composed from ``fft_stage_ref`` (on any device)."""
    from repro_torch.kernels.fft_stage.ops import run_passes
    return run_passes(x, n, fft_stage_ref)


def fft_oracle_digit_reversed(x: np.ndarray, radix: int = 4) -> np.ndarray:
    """np.fft result permuted to the DIF output (digit-reversed) order."""
    from repro_torch.isa.programs.fft import oracle_spectrum
    return oracle_spectrum(x, radix)
