"""Kernel registry (port of ``repro.kernels.registry``).

A ``Kernel`` bundles a kernel package's entry points behind one signature
whose first argument is a ``MemoryArchitecture`` (or a name
``repro_torch.core.arch.get`` resolves):

  * ``cuda(arch, *args)``  — the hand-written CUDA path on logical inputs
    (the reference's ``pallas`` field).  On a CPU tensor it runs the
    kernel's plain PyTorch version; on a CUDA tensor it launches the kernel;
  * ``ref(arch, *args)``   — the logical-table oracle;
  * ``trace(arch, *args)`` — the call's exact ``AddressTrace``;
  * ``blocks(arch, *args, block_ops=…)`` — the same request stream as
    ``TraceStream`` source blocks, built in O(block) memory.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from repro_torch.core import arch as _arch


@dataclass(frozen=True)
class Kernel:
    """One registered kernel: uniform (arch, *args) entry points."""
    name: str
    cuda: Callable
    ref: Callable
    trace: Callable | None = None
    blocks: Callable | None = None
    description: str = ""

    def run(self, arch, *args, **kwargs):
        """Dispatch the kernel path under an architecture (or its name)."""
        return self.cuda(_arch.resolve(arch), *args, **kwargs)

    def reference(self, arch, *args, **kwargs):
        return self.ref(_arch.resolve(arch), *args, **kwargs)

    def address_trace(self, arch, *args, **kwargs):
        """The exact AddressTrace this call issues."""
        if self.trace is None:
            raise NotImplementedError(
                f"kernel {self.name!r} has no address-trace generator")
        return self.trace(_arch.resolve(arch), *args, **kwargs)

    def trace_blocks(self, arch, *args, block_ops: int | None = None,
                     **kwargs):
        """The request stream of ``address_trace`` as a lazy, re-iterable
        ``TraceStream`` of at-most-``block_ops``-op blocks (bit-equal
        under ``cost_many`` at any block size)."""
        from repro_torch.core.trace import TraceStream
        a = _arch.resolve(arch)
        meta = {"kernel": self.name, "block_ops": block_ops}
        if self.blocks is not None:
            return TraceStream(
                functools.partial(self.blocks, a, *args,
                                  block_ops=block_ops, **kwargs),
                meta={**meta, "streamed": True})
        t = self.address_trace(a, *args, **kwargs)
        return TraceStream(functools.partial(t.blocks, block_ops), meta=meta)


_KERNELS: dict[str, Kernel] = {}

#: kernel packages that self-register on import (those of the ported
#: slices; the reference has seven)
_BUILTIN_PACKAGES = ("banked_gather", "banked_scatter")


def register(kernel: Kernel) -> Kernel:
    _KERNELS[kernel.name] = kernel
    return kernel


def _ensure_builtins() -> None:
    import importlib
    for pkg in _BUILTIN_PACKAGES:
        importlib.import_module(f"repro_torch.kernels.{pkg}")


def get(name: str) -> Kernel:
    """Resolve a kernel by name (imports the builtin packages on demand)."""
    if name not in _KERNELS:
        _ensure_builtins()
    try:
        return _KERNELS[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(_KERNELS)}") from None


def names() -> tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_KERNELS))


def _host(idx):
    """Trace construction is host work: index tensors come to numpy here."""
    import torch
    return idx.cpu().numpy() if isinstance(idx, torch.Tensor) else idx


def row_stream_trace(idx, kind: str = "load", mask=None):
    """A row-index request stream (array or tensor) as a one-instruction
    AddressTrace (rows are the banked unit, so the row stream is the
    address stream); ``mask`` predicates lanes off (e.g. unmapped paged-KV
    pages)."""
    from repro_torch.core.trace import AddressTrace
    return AddressTrace.from_stream(_host(idx), kind=kind, mask=mask)


def row_stream_blocks(idx, kind: str = "load", mask=None,
                      block_ops: int | None = None):
    """Streaming counterpart of ``row_stream_trace``: the same instruction
    as at-most-``block_ops``-op blocks (continuation chunks
    ``instr_carry``-marked, so the overhead is charged once)."""
    from repro_torch.core.trace import iter_op_chunks
    return iter_op_chunks(_host(idx), kind, mask=mask, block_ops=block_ops)
