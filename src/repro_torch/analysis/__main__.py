"""CLI for the analysis layer (port of ``python -m repro.analysis``, the
reference's CI ``lint-and-prove`` gate).

    python -m repro_torch.analysis --lint src --prove --check [--device D]

  * ``--lint PATH...`` — AST + registry lint (``analysis.lint``); any
    finding fails the run.
  * ``--prove`` — cross-check the symbolic conflict prover against the
    streaming cost engine on the Table II/III smoke points over the paper
    architecture grid: every proved ``TraceCost`` must equal ``cost_many``
    bit-exactly, and the paper's headline analytic facts (16B-xor transpose
    loads conflict-free; 16B lsb transpose stores 16-way serialized) are
    re-proved.
  * ``--check`` — run the trace-contract validator over every registered
    kernel's ``trace_blocks`` stream, both ISA program streams, the
    synthetic serving stream, and a recorded live ``ServeEngine``
    generation (smoke model); any contract violation fails the run.
  * ``--device`` (default ``cuda``) — where ``cross_check`` prices the
    engine's side, where the page allocators run, and where the smoke
    engine's weights live and its generation runs; ``cpu`` runs the whole
    CLI on the host.  The prover itself is host arithmetic either way.

No pass flag = all three.  Exit status 0 only when every selected pass is
clean; the lines printed are the reference CLI's, word for word.
"""
from __future__ import annotations

import argparse
import sys

PROVE_ARCHS = ("4B", "8B", "16B",
               "4B-offset", "8B-offset", "16B-offset",
               "16B-xor", "16B-fold", "16B-bcast", "16B-offset-s2",
               "4R-1W", "4R-2W", "4R-1W-VB")


def _run_lint(paths) -> int:
    from repro_torch.analysis.lint import lint_paths, registry_findings
    findings = lint_paths(paths) + registry_findings()
    for f in findings:
        print(f"lint: {f}")
    print(f"lint: {len(findings)} finding(s) over {', '.join(paths)}")
    return len(findings)


def _run_prove(device="cuda") -> int:
    import numpy as np

    from repro_torch.analysis.symbolic import cross_check, prove
    from repro_torch.core import arch as A
    from repro_torch.core.trace import AddressTrace
    from repro_torch.isa.programs import fft as fft_prog
    from repro_torch.isa.programs import transpose as tr_prog
    from repro_torch.kernels import registry as kreg

    archs = [A.get(n) for n in PROVE_ARCHS]
    failures = 0
    rng = np.random.default_rng(0)
    model_points = (
        ("attn_decode", (np.array([[0, 3, 6, -1], [1, 4, -1, -1],
                                   [2, 5, 7, -1]], np.int32),
                         np.array([17, 9, 21]), 64, 4, 8)),
        ("moe_a2a", (rng.integers(0, 8, size=64).astype(np.int32), 8, 16)),
        ("ssm_scan", (2, 64, 16, 4)),
    )
    points = (
        [(f"transpose {n}x{n}", tr_prog.symbolic_trace(n),
          AddressTrace.from_program(tr_prog.transpose_program(n)))
         for n in (16, 32, 64)]
        + [(f"fft {n} radix {r}", fft_prog.symbolic_trace(n, r),
            AddressTrace.from_program(fft_prog.fft_program(n, r)))
           for n, r in ((64, 4), (256, 4), (256, 16))]
        + [(f"kernel {name}", kreg.get(name).symbolic_trace("16B", *args),
            kreg.get(name).address_trace("16B", *args))
           for name, args in model_points]
    )
    for label, sym, trace in points:
        try:
            cross_check(archs, sym, trace, device=device)
            print(f"prove: {label}: proved == engine on "
                  f"{len(archs)} archs (bit-exact)")
        except AssertionError as e:
            failures += 1
            print(f"prove: {label}: MISMATCH — {e}")

    # The paper's analytic headline facts, re-proved every run.
    sym64 = tr_prog.symbolic_trace(64)
    xor = prove(A.get("16B-xor"), sym64).family("transpose64 row loads")
    lsb = prove(A.get("16B"), sym64).family("transpose64 column stores")
    if not xor.conflict_free:
        failures += 1
        print(f"prove: FACT FAILED — 16B-xor transpose loads not "
              f"conflict-free (max {xor.max_cycles} cycles)")
    if lsb.max_cycles != 16:
        failures += 1
        print(f"prove: FACT FAILED — 16B lsb column stores expected "
              f"16-way serialized, proved {lsb.max_cycles}")
    if not failures:
        print("prove: facts hold — 16B-xor transpose loads conflict-free; "
              "16B lsb column stores 16-way serialized")
    return failures


def _check_one(label, trace, arch) -> int:
    from repro_torch.analysis.contracts import TraceContractError, validate
    try:
        rep = validate(trace, arch)
        print(f"check: {label}: ok ({rep.n_blocks} blocks, "
              f"{rep.n_ops} ops, {rep.n_instructions} instructions)")
        return 0
    except TraceContractError as e:
        print(f"check: {label}: CONTRACT VIOLATION — {e}")
        return 1


def _run_check(device="cuda") -> int:
    import numpy as np

    from repro_torch.core import arch as A
    from repro_torch.core.trace import TraceStream
    from repro_torch.isa.programs.fft import fft_program
    from repro_torch.isa.programs.transpose import transpose_program
    from repro_torch.isa.vm import program_trace_stream
    from repro_torch.kernels import registry as kreg
    from repro_torch.serving.kvcache import simulate_serving_stream

    arch = A.get("16B")
    rng = np.random.default_rng(0)
    table = rng.standard_normal((256, 16)).astype(np.float32)
    idx = rng.integers(0, 256, size=64).astype(np.int32)
    kernel_args = {
        "banked_gather": (table, idx),
        "banked_scatter": (table, idx),
        "banked_transpose": (np.arange(32 * 32, dtype=np.float32)
                             .reshape(32, 32),),
        "carry_arbiter": (rng.integers(0, 1 << 16, size=(48, 16))
                          .astype(np.uint32),),
        "conflict_popcount": (rng.integers(0, 16, size=(48, 16))
                              .astype(np.int32),),
        "fft_stage": (np.zeros((1, 256), np.complex64),),
        "moe_dispatch": (rng.integers(0, 8, size=128).astype(np.int32),
                         8, 32),
        # model traffic lowerings (repro_torch.models.trace)
        "attn_decode": (np.array([[0, 3, 6, -1], [1, 4, -1, -1],
                                  [2, 5, 7, -1]], np.int32),
                        np.array([17, 9, 21]), 64, 4, 8),
        "moe_a2a": (rng.integers(0, 8, size=64).astype(np.int32), 8, 16),
        "ssm_scan": (2, 64, 16, 4),
    }
    failures = 0
    for name in kreg.names():
        k = kreg.get(name)
        args = kernel_args[name]
        blocks = TraceStream(lambda k=k, args=args:
                             k.trace_blocks(arch, *args, block_ops=64))
        failures += _check_one(f"kernel {name} trace_blocks", blocks, arch)
        failures += _check_one(f"kernel {name} trace",
                               k.trace(arch, *args), arch)

    for label, prog in (("transpose_program(32)", transpose_program(32)),
                        ("fft_program(256, 4)", fft_program(256, 4))):
        failures += _check_one(f"ISA {label}",
                               program_trace_stream(prog), arch)

    failures += _check_one(
        "simulate_serving_stream(b=2, plen=12, steps=6)",
        simulate_serving_stream(arch, batch=2, prompt_len=12,
                                decode_steps=6, page_len=8, device=device),
        arch)

    from repro_torch.models.trace import (model_step_trace,
                                          resolve_model_config)
    failures += _check_one(
        "model_step_trace(llama3.2-1b smoke)",
        model_step_trace(resolve_model_config("llama3.2-1b", smoke=True),
                         arch, batch=2, prompt_len=12, block_ops=64,
                         device=device), arch)

    failures += _check_engine(arch, device)
    return failures


def _check_engine(arch, device="cuda") -> int:
    """Record a live smoke-model generation on ``device`` (weights from a
    seeded ``torch.Generator`` there) and validate its KV stream."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.sharding import NO_AXES
    from repro_torch.models import init_tree, model_specs
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke_config("llama3.2-1b")
    rc = RunConfig(remat="none", attn_impl="dense")
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_tree(model_specs(cfg), gen, device=device)
    eng = ServeEngine(cfg, rc, params, NO_AXES, kv_mode="paged", max_batch=2,
                      max_seq=24, page_len=8, device=device)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    eng.generate(prompts, max_new_tokens=4)
    return _check_one("ServeEngine recorded serving_stream",
                      eng.serving_stream(include_prefill=True), arch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="trace-contract checker, symbolic conflict prover and "
                    "repo lint (the CI lint-and-prove gate)")
    ap.add_argument("--lint", nargs="*", metavar="PATH",
                    help="AST+registry lint over PATHs (default: src)")
    ap.add_argument("--prove", action="store_true",
                    help="cross-check the symbolic prover vs the cost "
                         "engine on the smoke points")
    ap.add_argument("--check", action="store_true",
                    help="validate kernel/ISA/serving trace streams "
                         "against the Trace contract")
    ap.add_argument("--device", default="cuda",
                    help="where the engine prices, the allocators run and "
                         "the smoke engine serves (default: cuda)")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" and (
            not torch.cuda.is_available()):
        ap.error("no CUDA device; pass --device cpu to run on the host")

    run_lint = args.lint is not None
    run_prove = args.prove
    run_check = args.check
    if not (run_lint or run_prove or run_check):
        run_lint = run_prove = run_check = True
        args.lint = []

    failures = 0
    if run_lint:
        failures += _run_lint(tuple(args.lint) or ("src",))
    if run_prove:
        failures += _run_prove(args.device)
    if run_check:
        failures += _run_check(args.device)
    print(f"analysis: {'OK' if not failures else f'{failures} failure(s)'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
