"""Build and bind the hand-written CUDA kernels of ``repro_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), loaded
with ``ctypes``.  The build runs at first use into ``build/`` at the root
of the checkout, under a name keyed by the source's content hash, so an
edited source is never served by a stale library.  Nothing here runs at
import: the CPU tests import every module on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``ptxas -v``: registers, spills) of the
    built library of ``csrc/<name>.cu``."""
    return library_path(name).with_suffix(".log").read_text()


def _build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)          # atomic: concurrent builders never clash
    return out


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = ctypes.CDLL(str(_build(name)))
    err = getattr(lib, f"{name}_error_string")   # every library exports one
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


class CudaEntry:
    """One C entry point of a kernel library and its launch count.

    Calling it appends the current stream, launches, and raises if the
    entry's ``cudaGetLastError()`` is not 0; ``launches`` counts the
    successful launches (the one place a kernel launch is counted)."""

    def __init__(self, lib: str, symbol: str, argtypes: list):
        self.lib, self.symbol = lib, symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]    # + the stream
        self.launches = 0
        self._fn = None

    def _bind(self):
        fn = getattr(library(self.lib), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def __call__(self, *args) -> None:
        fn = self._fn or self._bind()
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            msg = getattr(library(self.lib),
                          f"{self.lib}_error_string")(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1
