"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Each kernel package ships ``ops.py`` (the wrapper: checks, the CUDA launch,
the plain version for CPU tensors, trace generators) and ``ref.py`` (the
logical oracle); the CUDA sources live in ``repro_torch/csrc`` and build at
first use (``cuda_lib``).  Packages self-register with ``registry``.

Kernels (ported slices):
  banked_gather  — bank-major row gather (paged-KV read path)
  banked_scatter — bank-major row scatter, in place (paged-KV write path)
  banked_transpose — shared-memory tiled transpose (Table II data path)
  fft_stage      — radix-4 DIF FFT pass (Table III data path)
  conflict_popcount — issue-controller conflict counting (one-hot popcount
                   + max) over operation batches
  carry_arbiter  — the carry-chain arbiter's grant schedule
  moe_dispatch   — each request's position within its expert (the
                   arbiter's grant order over a flat request stream)
"""
from repro_torch.kernels import registry
from repro_torch.kernels.registry import Kernel, register, register_kernel

get = registry.get
names = registry.names

__all__ = ["registry", "Kernel", "register", "register_kernel", "get",
           "names"]
