"""Kernel micro-bench on the card: the counterpart of
``benchmarks/kernel_bench.py``.

    python -m repro_torch.bench.kernel_bench [--device cuda|cpu]

Each row runs one ported kernel through its wrapper at the reference's
shape (``benchmarks/kernel_bench.py:29-57``, its six rows in its order):
``banked_gather_1024x512_r256``, ``conflict_popcount_4096ops``,
``carry_arbiter_1024ops``, ``moe_dispatch_8192req_e16``,
``fft4096_radix4_b4``, ``banked_transpose_512``.

CSV: ``name,us_per_call,derived``, as the reference prints it.  On the card
``us_per_call`` is CUDA events over back-to-back calls from Python, ending
in a sync; ``derived`` holds ``device_us`` (the same calls replayed from one
CUDA graph: device time alone), ``bound_us`` (the bytes the function must
move, each input read once and each output written once, over the H100's
3.35 TB/s), ``err`` (the max abs difference from the kernel's plain PyTorch
version on the same inputs) and the timer with the card's name.  The
device is the card unless ``--device cpu`` is given: then the wrappers run
their plain versions, ``us_per_call`` is the host clock and ``device_us``
is not measured.  Without a card the default fails instead of running on
the host.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate (data sheet)
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores


def time_ms(fn, iters: int = 200) -> float:
    """Per call from Python: CUDA events around ``iters`` back-to-back calls
    after 10 warm-up calls, ending in a sync."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 100) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so no host dispatch sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The larger of bytes over the memory rate and flops over the f32
    rate, in ms, and which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(kern, plain, lib, bound, graph_iters: int, iters: int) -> dict:
    """Per call from Python (plain, kernel, kernel, plain in turns), the
    library call, and device times from a CUDA graph."""
    p1, k1, k2, p2 = (time_ms(plain, iters), time_ms(kern, iters),
                      time_ms(kern, iters), time_ms(plain, iters))
    return {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
            "plain_ms_runs": [p1, p2],
            "library_ms": time_ms(lib, iters) if lib else None,
            "device_ms": graph_ms(kern, graph_iters),
            "library_device_ms": (graph_ms(lib, graph_iters) if lib
                                  else None),
            "bound_ms": bound[0], "bound_by": bound[1]}


def _host_us(fn, iters: int = 3) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def _max_err(got, want) -> float:
    """Max abs difference over a result or a tuple of results."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return max((g.to(torch.complex128) - w.to(torch.complex128)).abs().max()
               .item() for g, w in pairs)


def cases(device) -> list[tuple]:
    """(name, kernel, plain version, inputs, bytes moved) for each row, the
    inputs made from seed 0 on ``device``; bytes count each input read once
    and each output written once."""
    from repro_torch.core.arch import BankedLayout
    from repro_torch.kernels.banked_gather.ops import (banked_gather,
                                                       banked_gather_plain)
    from repro_torch.kernels.banked_transpose.ops import banked_transpose
    from repro_torch.kernels.banked_transpose.ref import banked_transpose_ref
    from repro_torch.kernels.carry_arbiter.ops import (carry_arbiter,
                                                       carry_arbiter_plain)
    from repro_torch.kernels.conflict_popcount.ops import (
        conflict_popcount, conflict_popcount_plain)
    from repro_torch.kernels.fft_stage import fft4096_radix4, fft_radix4_ref
    from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                      moe_dispatch_positions)

    rng = np.random.default_rng(0)

    def put(a):
        return torch.from_numpy(a).to(device)

    table = BankedLayout(16).to_banked(put(rng.standard_normal((1024, 512),
                                                               np.float32)))
    idx = put(rng.integers(0, 1024, 256))
    banks = put(rng.integers(0, 16, (4096, 16)).astype(np.int32))
    reqs = put(rng.integers(0, 2 ** 16, (1024, 16)))
    x = put((rng.standard_normal((4, 4096)) + 1j * rng.standard_normal(
        (4, 4096))).astype(np.complex64))
    m = put(rng.standard_normal((512, 512), np.float32))
    experts = put(rng.integers(0, 16, 8192).astype(np.int32))
    return [
        # 256 rows of 512 f32 read and written, 256 int64 indices
        ("banked_gather_1024x512_r256", banked_gather, banked_gather_plain,
         (table, idx, 16), 2 * 256 * 512 * 4 + 256 * 8),
        # (4096, 16) int32 ids in; (4096, 16) counts and 4096 cycles out
        ("conflict_popcount_4096ops", conflict_popcount,
         conflict_popcount_plain, (banks, 16),
         4096 * 16 * 4 + 4096 * 16 * 4 + 4096 * 4),
        # the function on 32-bit words: (1024, 16) in, (1024, 16, 16) out
        ("carry_arbiter_1024ops", carry_arbiter, carry_arbiter_plain,
         (reqs,), 1024 * 16 * 4 + 1024 * 16 * 16 * 4),
        # 8192 int32 ids in; 8192 int32 positions and 8192 bool kept out
        ("moe_dispatch_8192req_e16", moe_dispatch_positions,
         moe_dispatch_plain, (experts, 16, 1024), 8192 * (4 + 4 + 1)),
        # 4 × 4096 complex64 in and out
        ("fft4096_radix4_b4", fft4096_radix4, fft_radix4_ref, (x,),
         2 * 4 * 4096 * 8),
        ("banked_transpose_512", banked_transpose, banked_transpose_ref,
         (m,), 2 * 512 * 512 * 4),
    ]


def rows(device="cuda") -> list[dict]:
    """Time each row's kernel on ``device`` and hold it to its plain
    version; returns one record per row."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    timer = (f"cuda events on {torch.cuda.get_device_name(device)}"
             if on_card else f"host clock on {device.type}")
    out = []
    for name, kern, plain, args, n_bytes in cases(device):
        err = _max_err(kern(*args), plain(*args))

        def call(kern=kern, args=args):
            return kern(*args)
        if on_card:
            us, device_us = time_ms(call) * 1e3, graph_ms(call) * 1e3
        else:
            us, device_us = _host_us(call), None
        out.append({"name": name, "us_per_call": us, "device_us": device_us,
                    "bound_us": bound_ms(n_bytes)[0] * 1e3, "err": err,
                    "timer": timer})
    return out


def format_row(r: dict) -> str:
    dev = ("not measured" if r["device_us"] is None
           else f"{r['device_us']:.3f}")
    return (f"{r['name']},{r['us_per_call']:.3f},device_us={dev}|"
            f"bound_us={r['bound_us']:.3f}|err={r['err']}|"
            f"timer={r['timer']}")


def main(argv=None) -> list[dict]:
    """Print the rows; returns them."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.kernel_bench",
        description="The ported kernels timed on the card against their "
                    "bounds and held to their plain versions.")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the kernels run (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("kernel_bench: no CUDA device; the bench runs on "
                         "the card (pass --device cpu to run on the host)")
    out = rows(args.device)
    for r in out:
        print(format_row(r), flush=True)
    return out


if __name__ == "__main__":
    main()
