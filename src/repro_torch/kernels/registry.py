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
    ``TraceStream`` source blocks, built in O(block) memory;
  * ``cost(arch, *args)`` — an opaque cycle count, for a kernel with no
    trace; ``cost_cycles`` prices the trace when there is one;
  * ``symbolic(arch, *args)`` — the call's address stream as closed-form
    lane families (a ``repro_torch.analysis.symbolic.SymbolicTrace``), the
    input of the conflict prover.

New kernels are one decorator away::

    @register_kernel("my_kernel", ref=my_ref, trace=my_trace,
                     blocks=my_trace_blocks)
    def my_cuda(arch, x):
        ...
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
    cost: Callable | None = None
    symbolic: Callable | None = None
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

    def symbolic_trace(self, arch, *args, **kwargs):
        """The kernel's address stream as a ``SymbolicTrace`` (closed-form
        lane families; see ``repro_torch.analysis.symbolic``): ``prove``
        derives per-instruction max-conflict bounds and a full
        ``TraceCost`` from it on the host, bit-equal to
        ``cost_many`` on ``address_trace``."""
        if self.symbolic is None:
            raise NotImplementedError(
                f"kernel {self.name!r} has no symbolic trace description")
        return self.symbolic(_arch.resolve(arch), *args, **kwargs)

    def cost_cycles(self, arch, *args, device="cuda", **kwargs):
        """Cycles this operation costs under ``arch``'s timing model
        (= ``arch.cost(self.trace(arch, *args)).total_cycles``, priced on
        ``device``); a kernel without a trace answers with its ``cost``."""
        a = _arch.resolve(arch)
        if self.trace is not None:
            return a.cost(self.trace(a, *args, **kwargs),
                          device=device).total_cycles
        if self.cost is not None:
            return self.cost(a, *args, **kwargs)
        raise NotImplementedError(
            f"kernel {self.name!r} has no cost model")


_KERNELS: dict[str, Kernel] = {}

#: kernel packages that self-register on import (the reference's seven)
_BUILTIN_PACKAGES = ("banked_gather", "banked_scatter", "banked_transpose",
                     "carry_arbiter", "conflict_popcount", "fft_stage",
                     "moe_dispatch")

#: modules outside ``repro_torch.kernels`` that also self-register kernels
#: on import (the whole-model traffic lowerings attn_decode, moe_a2a and
#: ssm_scan), so ``get`` and ``names`` see them without a manual import
_BUILTIN_MODULES = ("repro_torch.models.trace",)


def register(kernel: Kernel) -> Kernel:
    _KERNELS[kernel.name] = kernel
    return kernel


def register_kernel(name: str, *, ref: Callable,
                    trace: Callable | None = None,
                    blocks: Callable | None = None,
                    cost: Callable | None = None,
                    symbolic: Callable | None = None,
                    description: str = "") -> Callable:
    """Decorator form: registers the decorated function as the kernel
    entry point of a new Kernel and returns the Kernel."""
    def deco(cuda: Callable) -> Kernel:
        return register(Kernel(name=name, cuda=cuda, ref=ref, trace=trace,
                               blocks=blocks, cost=cost, symbolic=symbolic,
                               description=description))
    return deco


def _ensure_builtins() -> None:
    import importlib
    for pkg in _BUILTIN_PACKAGES:
        importlib.import_module(f"repro_torch.kernels.{pkg}")
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


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


def host_array(idx):
    """Trace construction is host work: index tensors come to numpy here."""
    import torch
    return idx.cpu().numpy() if isinstance(idx, torch.Tensor) else idx


def row_stream_trace(idx, kind: str = "load", mask=None):
    """A row-index request stream (array or tensor) as a one-instruction
    AddressTrace (rows are the banked unit, so the row stream is the
    address stream); ``mask`` predicates lanes off (e.g. unmapped paged-KV
    pages)."""
    from repro_torch.core.trace import AddressTrace
    return AddressTrace.from_stream(host_array(idx), kind=kind, mask=mask)


def row_stream_blocks(idx, kind: str = "load", mask=None,
                      block_ops: int | None = None):
    """Streaming counterpart of ``row_stream_trace``: the same instruction
    as at-most-``block_ops``-op blocks (continuation chunks
    ``instr_carry``-marked, so the overhead is charged once)."""
    from repro_torch.core.trace import iter_op_chunks
    return iter_op_chunks(host_array(idx), kind, mask=mask,
                          block_ops=block_ops)


def row_stream_cost(arch, idx, is_write: bool, device="cuda") -> int:
    """Cost a row-index request stream under ``arch``, priced on ``device``
    (= ``arch.cost(row_stream_trace(idx, ...)).total_cycles``)."""
    kind = "store" if is_write else "load"
    return arch.cost(row_stream_trace(idx, kind), device=device).total_cycles
