"""The paper's workloads as declarative ``Workload`` values, plus the
serving workload the paged-KV engine opened up (port of
``repro.bench.workloads``).

Table II: N×N matrix transpose (N ∈ {32, 64, 128}); Table III: 4096-point
Cooley-Tukey FFT (radix ∈ {4, 8, 16}), functionally verified against numpy.
``serving_workload`` is a ``TraceWorkload``: paged-KV prefill + decode
traffic lowered per-architecture (the page allocator follows the arch's
bank map); ``scheduler_workload`` is a continuous-batching serving day;
``model_workload`` is one whole-model decode step.
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


def _layout_key(arch):
    """The lowering key of the serving traces: they depend only on the
    architecture's banked layout (every layout-free memory prices the
    canonical 16-bank LSB pool's stream)."""
    lay = arch.layout
    return ("dense-canonical" if lay is None
            else (lay.n_banks, lay.mapping, lay.shift))


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

    return TraceWorkload(
        name=name or f"serve_b{batch}_p{prompt_len}_d{decode_steps}",
        trace_fn=trace_fn,
        meta={"batch": batch, "prompt_len": prompt_len,
              "decode_steps": decode_steps, "page_len": page_len,
              "n_kv_layers": n_kv_layers},
        lowering_key=_layout_key,
        stream_fn=stream_fn)


def model_workload(config_name: str = "llama3_2_1b", batch: int = 4,
                   prompt_len: int = 32, page_len: int = 8,
                   block_ops: int | None = 4096, seed: int = 0,
                   name: str | None = None, device="cuda") -> TraceWorkload:
    """One whole-model decode step (``repro_torch.models.model_step_trace``)
    as a sweep/tune workload: attention + RoPE + paged-KV gathers, MoE
    all-to-all dispatch, and SSM state updates stitched per the model
    config's layer pattern (llama3_2_1b / mixtral_8x22b / jamba_v0_1_52b),
    its pages allocated on ``device``.

    Like ``serving_workload`` the lowering is per banked layout: the KV
    page allocator places pages under the arch's bank map, so the step's
    address stream is a property of the (architecture, traffic) pair.
    Streams are priced in O(block) memory through the ``Trace`` protocol:
    a 56-layer Mixtral step never materializes.  ``meta["n_tokens"]`` (one
    token per sequence per step) feeds the ``us_per_token`` objective.
    """
    from repro_torch.models.trace import (model_step_trace,
                                          resolve_model_config)
    cfg = resolve_model_config(config_name)
    kw = dict(batch=batch, prompt_len=prompt_len, page_len=page_len,
              block_ops=block_ops, seed=seed, device=device)

    def stream_fn(arch):
        return model_step_trace(cfg, arch, **kw)

    def trace_fn(arch):
        # per-cell introspection only; sweeps price the stream
        return stream_fn(arch).materialize()    # lint: allow-materialize

    return TraceWorkload(
        name=name or f"model_{config_name}_b{batch}_p{prompt_len}",
        trace_fn=trace_fn,
        meta={"model": cfg.name, "batch": batch, "prompt_len": prompt_len,
              "page_len": page_len, "seed": seed, "n_layers": cfg.n_layers,
              "n_tokens": batch},
        lowering_key=_layout_key,
        stream_fn=stream_fn)


def scheduler_workload(n_requests: int = 64, arrival_rate: float = 1.0,
                       context_dist: str = "mixed", n_lanes: int = 16,
                       max_seq: int = 256, page_len: int = 8,
                       n_kv_layers: int = 2, policy: str = "seq-skew",
                       seed: int = 0, name: str | None = None
                       ) -> TraceWorkload:
    """Continuous-batching serving traffic (one seeded serving day:
    ``n_requests`` jobs at ``arrival_rate`` with ``context_dist`` context
    lengths, scheduled lane-ragged by ``repro_torch.serving.scheduler``) as
    a sweep/tune workload.

    Like ``serving_workload`` the lowering is per banked layout (the
    scheduler's page pool places pages under the arch's bank map, skewed by
    ``policy``), cached per ``lowering_key`` and priced in O(block) memory
    through the streaming ``Trace`` protocol.  ``meta["n_tokens"]`` (the
    day's generated tokens) feeds the ``us_per_token`` tune objective.
    """
    from repro_torch.serving.scheduler import (simulate_scheduler_stream,
                                               synthesize_requests,
                                               total_new_tokens)
    reqs = synthesize_requests(n_requests, arrival_rate=arrival_rate,
                               context_dist=context_dist, max_seq=max_seq,
                               seed=seed)
    kw = dict(n_lanes=n_lanes, max_seq=max_seq, page_len=page_len,
              n_kv_layers=n_kv_layers, policy=policy)

    def stream_fn(arch):
        return simulate_scheduler_stream(arch, reqs, **kw)

    def trace_fn(arch):
        # per-cell introspection only; sweeps price the stream
        return stream_fn(arch).materialize()    # lint: allow-materialize

    return TraceWorkload(
        name=name or (f"sched_n{n_requests}_r{arrival_rate:g}"
                      f"_{context_dist}_{policy}"),
        trace_fn=trace_fn,
        meta={"n_requests": n_requests, "arrival_rate": arrival_rate,
              "context_dist": context_dist, "n_lanes": n_lanes,
              "max_seq": max_seq, "page_len": page_len,
              "n_kv_layers": n_kv_layers, "policy": policy, "seed": seed,
              "n_tokens": total_new_tokens(reqs)},
        lowering_key=_layout_key,
        stream_fn=stream_fn)
