"""Radix-4 DIF FFT passes — the data path of the paper's Table III workload.

``fft_stage`` is the wrapper of one pass on the kernel layout: for CUDA
planes it launches the hand-written kernel of ``csrc/fft_stage.cu`` (which
replaces the Pallas ``fft_stage_kernel`` of
``src/repro/kernels/fft_stage/kernel.py``; the source says what bounds it),
for CPU planes it runs ``fft_stage_ref``, the same pass in plain PyTorch.
There is no fallback from one to the other.  ``fft_stage_radix4`` and
``fft4096_radix4`` keep the reference's signatures: one pass on (batch, n)
planes, and the log4 n passes composed (digit-reversed output, like the
SIMT program).  The trace generators give the Table III program's exact
request stream.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.cuda_lib import CudaEntry
from repro_torch.kernels.fft_stage.ref import fft_stage_ref

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong

#: the C entry and its launch count (``STAGE.launches``)
STAGE = CudaEntry("fft_stage", "fft_stage_launch",
                  [_P, _P, _P, _P, _P, _P, _I64, _I64])


def _stage_twiddles(n: int, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Pass p's twiddles W_m^{q·i}, (1, 4, sub) re and im planes: numpy
    complex128, cast to complex64 (as the reference computes them)."""
    m = n // 4 ** p
    sub = m // 4
    q = np.arange(sub)
    i = np.arange(4)[:, None]
    tw = np.exp(-2j * np.pi * (q[None, :] * i) / m).astype(np.complex64)
    return (tw.real[None], tw.imag[None])  # (1, 4, sub)


@functools.lru_cache(maxsize=None)
def stage_twiddles(n: int, p: int,
                   device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``_stage_twiddles`` as contiguous f32 tensors on ``device``, moved
    there once per (n, p, device)."""
    twr, twi = _stage_twiddles(n, p)
    return (torch.from_numpy(np.ascontiguousarray(twr)).to(device),
            torch.from_numpy(np.ascontiguousarray(twi)).to(device))


def _passes_of(n: int) -> int:
    passes = int(round(np.log(n) / np.log(4))) if n > 0 else 0
    if passes < 1 or 4 ** passes != n:
        raise ValueError(f"n={n} is not a power of 4")
    return passes


def fft_stage(xr: torch.Tensor, xi: torch.Tensor, twr: torch.Tensor,
              twi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One radix-4 DIF pass on (rows, 4, sub) f32 planes with (1, 4, sub)
    twiddles, into new planes: the CUDA kernel on CUDA planes, the plain
    version on CPU ones."""
    if xr.dim() != 3 or xr.shape[1] != 4 or xr.shape != xi.shape:
        raise ValueError(f"need two (rows, 4, sub) planes, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    rows, _, sub = xr.shape
    if twr.shape != (1, 4, sub) or twi.shape != (1, 4, sub):
        raise ValueError(f"need (1, 4, {sub}) twiddles, got "
                         f"{tuple(twr.shape)} and {tuple(twi.shape)}")
    planes = (xr, xi, twr, twi)
    if any(t.dtype != torch.float32 for t in planes):
        raise TypeError("the FFT pass takes f32 planes")
    if any(t.device != xr.device for t in planes):
        raise ValueError("planes and twiddles on different devices")
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("the FFT pass needs contiguous planes")
    if rows * sub == 0:
        raise ValueError("empty planes")
    if xr.device.type == "cpu":
        return fft_stage_ref(xr, xi, twr, twi)
    if xr.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got "
                         f"{xr.device}")
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    STAGE(xr.data_ptr(), xi.data_ptr(), twr.data_ptr(), twi.data_ptr(),
          yr.data_ptr(), yi.data_ptr(), rows, sub)
    return yr, yi


def _view(t: torch.Tensor, n: int, p: int) -> torch.Tensor:
    """(batch, n) plane -> pass p's (batch·4^p, 4, n / 4^(p+1)) layout."""
    return t.reshape(-1, 4, n // 4 ** (p + 1))


def fft_stage_radix4(xr: torch.Tensor, xi: torch.Tensor, n: int,
                     p: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply DIF pass p of a radix-4 size-n FFT to (batch, n) planes."""
    if not 0 <= p < _passes_of(n) or xr.dim() != 2 or xr.shape[1] != n:
        raise ValueError(f"pass {p} of n={n} on planes {tuple(xr.shape)}")
    twr, twi = stage_twiddles(n, p, xr.device)
    yr, yi = fft_stage(_view(xr, n, p), _view(xi, n, p), twr, twi)
    return yr.reshape(xr.shape), yi.reshape(xi.shape)


def run_passes(x: torch.Tensor, n: int, stage) -> torch.Tensor:
    """(batch, n) complex64 through the log4 n DIF passes of ``stage`` (a
    pass on the kernel layout: ``fft_stage`` or ``fft_stage_ref``); the
    spectrum comes out digit-reversed."""
    if x.dim() != 2 or x.shape[1] != n or x.dtype != torch.complex64:
        raise ValueError(f"need a (batch, {n}) complex64 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    passes = _passes_of(n)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    for p in range(passes):
        twr, twi = stage_twiddles(n, p, x.device)
        xr, xi = stage(_view(xr, n, p), _view(xi, n, p), twr, twi)
    return torch.complex(xr, xi).reshape(x.shape)


def fft4096_radix4(x: torch.Tensor, n: int = 4096) -> torch.Tensor:
    """(batch, n) complex64 -> FFT in digit-reversed order (batch, n):
    log4 n launches of the pass kernel on a CUDA tensor."""
    return run_passes(x, n, fft_stage)


def fft_trace(arch, x, **_):
    """Exact AddressTrace of the paper's radix-4 FFT benchmark on ``x``'s
    last axis (Table III): the two-word I/Q load, twiddle-load, and store
    streams of every DIF pass, per lane."""
    from repro_torch.core.trace import AddressTrace
    from repro_torch.isa.programs.fft import fft_program
    try:
        prog = fft_program(x.shape[-1], 4)
    except ValueError as e:
        raise NotImplementedError(str(e)) from None
    return AddressTrace.from_program(prog)


def fft_trace_blocks(arch, x, block_ops=None, **_):
    """Streaming counterpart of ``fft_trace``: the Table III program stream
    emitted block-by-block from the lazy pass-by-pass macro-op iterator;
    costs bit-equal to the dense trace at any block size."""
    from repro_torch.isa.programs.fft import iter_fft_instrs
    from repro_torch.isa.vm import instr_trace_blocks
    n = x.shape[-1]
    try:
        instrs = iter_fft_instrs(n, 4)
    except ValueError as e:
        raise NotImplementedError(str(e)) from None
    yield from instr_trace_blocks(instrs, n_threads=n // 4,
                                  block_ops=block_ops)
