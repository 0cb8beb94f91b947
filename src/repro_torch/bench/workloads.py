"""The paper's workloads as declarative ``Workload`` values, plus the
serving workload the paged-KV engine opened up (port of
``repro.bench.workloads``).

Table II: N×N matrix transpose (N ∈ {32, 64, 128}); Table III: 4096-point
Cooley-Tukey FFT (radix ∈ {4, 8, 16}), functionally verified against numpy.
``serving_workload`` is a ``TraceWorkload``: paged-KV prefill + decode
traffic lowered per-architecture (the page allocator follows the arch's
bank map).  The whole-model and scheduler workloads come with later slices.
"""
from __future__ import annotations

import numpy as np

from repro_torch.bench.runner import TraceWorkload, Workload
from repro_torch.isa.programs.fft import (fft_program, make_fft_memory,
                                          oracle_spectrum)
from repro_torch.isa.programs.transpose import oracle as transpose_oracle
from repro_torch.isa.programs.transpose import transpose_program


def transpose_workload(n: int) -> Workload:
    """N×N out-of-place transpose on [x | scratch] memory (Table II)."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n * n).astype(np.float32)
    mem0 = np.concatenate([x, np.zeros(n * n, np.float32)])
    want = transpose_oracle(n, x)

    def oracle(memory: np.ndarray) -> float:
        err = np.abs(memory - want)
        return float(err.max() / max(np.abs(want).max(), 1e-30))

    return Workload(name=f"transpose{n}", program=transpose_program(n),
                    init_memory=mem0, oracle=oracle, meta={"n": n})


def fft_workload(n: int = 4096, radix: int = 4, seed: int = 0) -> Workload:
    """n-point radix-R DIF FFT on interleaved I/Q data (Table III)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    mem0, _ = make_fft_memory(n, x)
    want = oracle_spectrum(x, radix)

    def oracle(memory: np.ndarray) -> float:
        got = memory[0:2 * n:2] + 1j * memory[1:2 * n:2]
        return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))

    return Workload(name=f"fft{n}r{radix}", program=fft_program(n, radix),
                    init_memory=mem0, oracle=oracle,
                    meta={"n": n, "radix": radix})


def serving_workload(batch: int = 4, prompt_len: int = 32,
                     decode_steps: int = 32, page_len: int = 8,
                     n_kv_layers: int = 2, name: str | None = None,
                     device="cuda") -> TraceWorkload:
    """Paged-KV serving traffic (prefill page writes + ``decode_steps``
    decode steps) as a sweep workload, its pages allocated on ``device``.

    The trace is re-lowered per architecture: the page allocator places
    pages per the arch's bank map, so the address stream — and the bank
    conflicts it causes — are a property of the (architecture, traffic)
    pair, exactly like the live ``ServeEngine``'s recorded step traces.
    The lowering only depends on the architecture's *banked layout* (every
    layout-free memory prices the canonical 16-bank LSB pool's stream), so
    that is the ``lowering_key``.
    """
    from repro_torch.serving.kvcache import (simulate_serving_stream,
                                             simulate_serving_trace)
    kw = dict(batch=batch, prompt_len=prompt_len, decode_steps=decode_steps,
              page_len=page_len, n_kv_layers=n_kv_layers, device=device)

    def trace_fn(arch):
        return simulate_serving_trace(arch, **kw)

    def stream_fn(arch):
        return simulate_serving_stream(arch, **kw)

    def lowering_key(arch):
        lay = arch.layout
        return ("dense-canonical" if lay is None
                else (lay.n_banks, lay.mapping, lay.shift))

    return TraceWorkload(
        name=name or f"serve_b{batch}_p{prompt_len}_d{decode_steps}",
        trace_fn=trace_fn,
        meta={"batch": batch, "prompt_len": prompt_len,
              "decode_steps": decode_steps, "page_len": page_len,
              "n_kv_layers": n_kv_layers},
        lowering_key=lowering_key,
        stream_fn=stream_fn)


def model_workload(*args, **kwargs) -> TraceWorkload:
    """Whole-model decode traffic (``repro.bench.model_workload``): comes
    with the port's MoE and whole-model traffic slice."""
    raise NotImplementedError(
        "model_workload comes with the port's MoE and whole-model traffic "
        "slice (models/trace.py is not ported yet)")


def scheduler_workload(*args, **kwargs) -> TraceWorkload:
    """Continuous-batching serving traffic
    (``repro.bench.scheduler_workload``): comes with the port's scheduler
    slice."""
    raise NotImplementedError(
        "scheduler_workload comes with the port's scheduler slice "
        "(serving/scheduler.py is not ported yet)")
