"""Radix-4 DIF FFT passes — the data path of the paper's Table III workload.

``fft_stage`` is the wrapper of one pass on the reference's planar layout:
for CUDA planes it launches ``radix4_pass`` of ``csrc/fft_stage.cu`` (which
replaces the Pallas ``fft_stage_kernel`` of
``src/repro/kernels/fft_stage/kernel.py``; the source says what bounds it),
for CPU planes it runs ``fft_stage_ref``, the same pass in plain PyTorch.
``fft_stage_radix4`` keeps the reference's one-pass signature.
``fft4096_radix4`` is the whole transform (digit-reversed output, like the
SIMT program): on a CUDA tensor one ``transform_tile`` launch runs every
pass whose segment fits ``TILE`` points in shared memory, after one
``wide_pass`` launch for each pass above that (``transform_plan``); on a CPU
tensor the plain passes run.  There is no fallback from one to the other.
The trace generators give the Table III program's exact request stream.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels.banked_gather.ops import require_cuda
from repro_torch.kernels.cuda_lib import CudaEntry
from repro_torch.kernels.fft_stage.ref import fft_radix4_ref, fft_stage_ref

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

#: the one-pass entry on planes and its launch count (``STAGE.launches``)
STAGE = CudaEntry("fft_stage", "fft_stage_launch",
                  [_P, _P, _P, _P, _P, _P, _I64, _I64])
#: the transform's entries: the tile kernel (every pass whose segment fits
#: a tile) and the device-memory pass on complex64 (each pass above that)
TRANSFORM = CudaEntry("fft_stage", "fft_transform_launch",
                      [_P, _P, _P, _I64, _I32])
WIDE_PASS = CudaEntry("fft_stage", "fft_wide_pass_launch",
                      [_P, _P, _P, _I64, _I32])

#: points a ``transform_tile`` block holds (kTile of the source), its
#: threads, and the passes of a tile-sized segment
TILE, TILE_THREADS = 4096, 256
TILE_PASSES = 6
#: the bit where each round's 4-bit window of the tile index sits, in the
#: order the kernel runs them (the ``tile_round<L, W>`` calls)
ROUND_WINDOWS = (8, 4, 0)


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


def transform_plan(n: int) -> int:
    """The first pass the tile kernel runs in a transform of ``n`` points:
    the passes before it work on segments above ``TILE`` points and take
    one ``wide_pass`` launch each, so a transform makes
    ``transform_plan(n) + 1`` launches."""
    return max(0, _passes_of(n) - TILE_PASSES)


def twiddle_offset(n: int, p: int) -> int:
    """Where pass p's (4, sub) table starts in ``transform_twiddles(n)``:
    the tables of the passes before it, n / 4^i points each."""
    return sum(n // 4 ** i for i in range(p))


def _transform_twiddles(n: int) -> np.ndarray:
    """Every pass's ``_stage_twiddles(n, p)`` as complex64, laid end to end
    (pass p at ``twiddle_offset(n, p)``): the table the transform kernels
    read, bit for bit the values the plain passes multiply by."""
    parts = []
    for p in range(_passes_of(n)):
        twr, twi = _stage_twiddles(n, p)
        tw = np.empty(twr.size, np.complex64)
        tw.real, tw.imag = twr.ravel(), twi.ravel()
        parts.append(tw)
    return np.concatenate(parts)


@functools.lru_cache(maxsize=None)
def transform_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """``_transform_twiddles(n)`` on ``device``, moved there once per (n,
    device)."""
    return torch.from_numpy(_transform_twiddles(n)).to(device)


def smem_word(a):
    """The tile kernel's shared-memory map: the word of tile point ``a``
    (0 <= a < TILE) in each of its re and im planes.  XORs the bank bits
    (0..4) with the index's bits 5..8 (into bits 0..3) and bit 8 (into bit
    4), so every warp access of every round falls on 32 distinct banks
    (``smem_word`` of ``csrc/fft_stage.cu``; ints or integer arrays)."""
    return a ^ (((a >> 5) & 15) | ((a >> 4) & 16))


def tile_point(t, j, w: int):
    """Thread t's j-th point (0 <= j < 16) of the tile in the round whose
    4-bit window sits at bit ``w``: the window holds j, the other 8 bits
    hold t (``tile_point<W>`` of the source).  The load and the store use
    the ``w = 8`` layout."""
    return ((t >> w) << (w + 4)) | (j << w) | (t & ((1 << w) - 1))


def round_passes(passes: int, w: int) -> tuple[int, ...]:
    """The local passes (of a ``4^passes``-point segment) that the round at
    window ``w`` runs: the two whose digits lie in bits w..w+3, those that
    exist (``tile_round<L, W>``)."""
    first = passes - 2 - w // 2
    return tuple(p for p in (first, first + 1) if p >= 0)


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


def check_transform(x: torch.Tensor, n: int) -> int:
    """A transform's input: (batch, n) of any real or complex dtype (taken
    as complex64, as the reference casts its real and imaginary parts to
    float32), n a power of 4; returns the number of passes."""
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"need a (batch, {n}) tensor, got "
                         f"{tuple(x.shape)}")
    return _passes_of(n)


def fft4096_radix4(x: torch.Tensor, n: int = 4096) -> torch.Tensor:
    """(batch, n) real or complex -> complex64 FFT in digit-reversed order
    (batch, n), bit-equal to the plain passes: ``transform_plan(n) + 1``
    launches on a CUDA tensor (one for n <= TILE), the plain passes on a
    CPU one.  Other dtypes are cast to complex64 first, on either path."""
    passes = check_transform(x, n)
    if x.shape[0] == 0:
        raise ValueError("empty batch")
    x = x.to(torch.complex64)
    if x.device.type == "cpu":
        return fft_radix4_ref(x, n)
    require_cuda(x)
    x = x.resolve_conj().contiguous()
    out = torch.empty_like(x)
    tw = transform_twiddles(n, x.device)
    first, src = transform_plan(n), x
    for p in range(first):
        sub = n // 4 ** (p + 1)
        WIDE_PASS(src.data_ptr(), out.data_ptr(),
                  tw.data_ptr() + 8 * twiddle_offset(n, p),
                  x.numel() // (4 * sub), sub.bit_length() - 1)
        src = out
    TRANSFORM(src.data_ptr(), out.data_ptr(),
              tw.data_ptr() + 8 * twiddle_offset(n, first), x.numel(),
              passes - first)
    return out


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
