"""The port's ISA layer (``repro_torch.isa``: assembler, VM, the transpose
and FFT programs) and ``AddressTrace.from_program`` held to the JAX
package on every Table II/III point (8 memories × N ∈ {32, 64, 128} and
9 memories × radix ∈ {4, 8, 16}), on the CPU.  Integers (traces,
``TraceCost``s) and the VM's final memory are compared bit for bit: the
functional execution is the same numpy code on the same inputs."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import arch as RA
from repro.core import cost_engine as RCE
from repro.core.trace import AddressTrace as RTrace
from repro.isa import assembler as RASM
from repro.isa import vm as RVM
from repro.isa.programs import fft as RFFT
from repro.isa.programs import transpose as RTR
from repro_torch.core import arch as PA
from repro_torch.core import cost_engine as PCE
from repro_torch.core.trace import AddressTrace as PTrace
from repro_torch.isa import assembler as PASM
from repro_torch.isa import vm as PVM
from repro_torch.isa.programs import fft as PFFT
from repro_torch.isa.programs import transpose as PTR

TRANSPOSE = [a.name for a in RA.TRANSPOSE_ARCHITECTURES]
PAPER = [a.name for a in RA.PAPER_ARCHITECTURES]
WORKLOADS = [("transpose", 32), ("transpose", 64), ("transpose", 128),
             ("fft", 4), ("fft", 8), ("fft", 16)]
#: every Table II/III point: 8 × 3 + 9 × 3 = 51
POINTS = ([(w, a) for w in WORKLOADS[:3] for a in TRANSPOSE]
          + [(w, a) for w in WORKLOADS[3:] for a in PAPER])

_CACHE: dict = {}


def _workload(key):
    """(reference program, port program, initial memory) of one Table
    II/III workload, inputs from a numpy seed (built once per process)."""
    if key not in _CACHE:
        kind, k = key
        if kind == "transpose":
            x = np.random.default_rng(k).standard_normal(k * k).astype(
                np.float32)
            mem0 = np.concatenate([x, np.zeros(k * k, np.float32)])
            _CACHE[key] = (RTR.transpose_program(k),
                           PTR.transpose_program(k), mem0)
        else:
            rng = np.random.default_rng(0)
            x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
                 ).astype(np.complex64)
            mem0, tw = PFFT.make_fft_memory(4096, x)
            want, want_tw = RFFT.make_fft_memory(4096, x)
            np.testing.assert_array_equal(mem0, want)
            assert tw == want_tw
            _CACHE[key] = (RFFT.fft_program(4096, k),
                           PFFT.fft_program(4096, k), mem0)
    return _CACHE[key]


def _asdict(c) -> dict:
    return dataclasses.asdict(c)


def _same_trace(got, want):
    for f in ("addrs", "kinds", "instr", "mask"):
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)
            assert g.dtype == w.dtype, f
    assert got.compute_cycles == want.compute_cycles
    assert got.op_counts == want.op_counts


def test_table_architectures_equal_the_reference():
    assert [a.name for a in PA.TRANSPOSE_ARCHITECTURES] == TRANSPOSE
    assert len(TRANSPOSE) == 8 and "4R-1W-VB" not in TRANSPOSE
    for p, r in zip(PA.TRANSPOSE_ARCHITECTURES, RA.TRANSPOSE_ARCHITECTURES):
        assert dataclasses.asdict(p.spec) == dataclasses.asdict(r.spec)


@pytest.mark.parametrize("addrs", [
    np.arange(32), np.arange(20), np.arange(7) * 5,
    np.stack([np.arange(16), 100 + np.arange(16)]),
    np.stack([np.arange(40), 3 * np.arange(40)]).astype(np.int32)])
def test_to_ops_equals_the_reference(addrs):
    got, want = PASM.to_ops(addrs), RASM.to_ops(addrs)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("key", WORKLOADS, ids=str)
def test_programs_lower_to_the_reference_trace(key):
    ref, port, _ = _workload(key)
    assert (port.name, port.n_threads, port.meta) == (
        ref.name, ref.n_threads, ref.meta)
    assert len(port.instrs) == len(ref.instrs)
    assert port.op_counts() == ref.op_counts()
    assert port.compute_cycles() == ref.compute_cycles()
    want = RTrace.from_program(ref)
    _same_trace(PTrace.from_program(port), want)
    _same_trace(port.address_trace(), want)
    _same_trace(PVM.program_trace(port), want)
    assert PTrace.from_program(port).meta == want.meta
    for got_l, want_l in zip(port.mem_traces(), ref.mem_traces()):
        assert len(got_l) == len(want_l)
        for g, w in zip(got_l, want_l):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("key,arch", POINTS, ids=str)
def test_run_program_equals_the_reference(key, arch):
    ref, port, mem0 = _workload(key)
    spec = PA.get(arch).spec
    got = PVM.run_program(port, spec, mem0, device="cpu")
    want = RVM.run_program(ref, RA.get(arch).spec, mem0)
    np.testing.assert_array_equal(got.memory, want.memory)
    assert got.memory.dtype == want.memory.dtype
    assert _asdict(got.cost) == _asdict(want.cost)
    assert (got.total_cycles, got.time_us, got.fmax_mhz) == (
        want.total_cycles, want.time_us, want.fmax_mhz)
    assert _asdict(PVM.cost_only(port, spec, device="cpu")) == _asdict(
        want.cost)
    timing = PA.get(arch).run_program(port, mem0, execute=False,
                                      device="cpu")
    assert _asdict(timing.cost) == _asdict(want.cost)
    np.testing.assert_array_equal(timing.memory, mem0)


@pytest.mark.parametrize("block_ops", [1, 7, 64, "n"])
@pytest.mark.parametrize("key", WORKLOADS, ids=str)
def test_streamed_equals_dense_equals_the_reference(key, block_ops):
    ref, port, _ = _workload(key)
    archs = TRANSPOSE if key[0] == "transpose" else PAPER
    dense = PTrace.from_program(port)
    b = dense.n_ops if block_ops == "n" else block_ops
    want = [_asdict(c) for c in RCE.cost_many(archs,
                                              RTrace.from_program(ref))]
    streamed = PCE.cost_many(archs, PVM.program_trace_stream(port, b),
                             device="cpu")
    assert [_asdict(c) for c in streamed] == want
    assert [_asdict(c) for c in PCE.cost_many(
        archs, dense, block_ops=b, device="cpu")] == want


def test_trace_blocks_equal_the_reference_blocks():
    for key in (("transpose", 64), ("fft", 8)):
        ref, port, _ = _workload(key)
        got = list(PVM.instr_trace_blocks(port.instrs, port.n_threads, 7))
        want = list(RVM.instr_trace_blocks(ref.instrs, ref.n_threads, 7))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_trace(g, w)
            assert g.meta == w.meta


def test_vm_result_trace_is_the_dense_program_trace():
    _, port, mem0 = _workload(("transpose", 32))
    res = PA.get("16B").run_program(port, mem0, device="cpu")
    _same_trace(res.trace, PTrace.from_program(port))


def test_default_memory_image_equals_the_reference():
    ref, port, _ = _workload(("transpose", 32))
    got = PA.get("16B-offset").run_program(port, device="cpu")
    want = RA.get("16B-offset").run_program(ref)
    np.testing.assert_array_equal(got.memory, want.memory)
    assert _asdict(got.cost) == _asdict(want.cost)


def test_oracles_equal_the_reference():
    for radix in (4, 8, 16):
        np.testing.assert_array_equal(
            PFFT.digit_reverse_indices(4096, radix),
            RFFT.digit_reverse_indices(4096, radix))
    x = (np.random.default_rng(3).standard_normal(1024)
         + 1j * np.random.default_rng(4).standard_normal(1024)).astype(
        np.complex64)
    for radix in (4, 32):
        np.testing.assert_array_equal(PFFT.oracle_spectrum(x, radix),
                                      RFFT.oracle_spectrum(x, radix))
    a = np.random.default_rng(5).standard_normal(32 * 32)
    np.testing.assert_array_equal(PTR.oracle(32, a), RTR.oracle(32, a))
    assert [PTR.transpose_n_threads(n) for n in (16, 32, 64, 128)] == [
        RTR.transpose_n_threads(n) for n in (16, 32, 64, 128)]


def test_fft_program_refuses_what_the_reference_refuses():
    for fn in (PFFT.fft_program, PFFT.iter_fft_instrs):
        with pytest.raises(ValueError):
            fn(4096, 32)
        with pytest.raises(ValueError):
            fn(1000, 4)


def test_multiword_instructions_equal_the_reference():
    """The reference's ISA units (two-word I/Q instructions pay one
    overhead, split functionally; scalar vs vector compute buckets) on
    the port, each result equal to the reference's."""
    a = np.arange(16, dtype=np.int32)
    progs = []
    for asm in (RASM, PASM):
        p = asm.Program("paired", 16)
        p.load(("re", "im"), np.stack([2 * a, 2 * a + 1]))
        p.store(("re", "im"), np.stack([64 + 2 * a, 64 + 2 * a + 1]))
        p.load("r0", 2 * a)
        p.load("r1", 2 * a + 1)
        p.compute({"fp": 3, "int": 2})
        p.compute({"other": 5}, scalar=True)
        progs.append(p)
    mem = np.concatenate([np.arange(32, dtype=np.float32),
                          np.zeros(96, np.float32)])
    want = RVM.run_program(progs[0], RA.get("16B").spec, mem)
    got = PVM.run_program(progs[1], PA.get("16B").spec, mem, device="cpu")
    np.testing.assert_array_equal(got.memory[64:96], mem[:32])
    np.testing.assert_array_equal(got.memory, want.memory)
    assert _asdict(got.cost) == _asdict(want.cost)
    assert got.cost.other_ops == 5 and got.cost.fp_ops == 3


@settings(deadline=None, database=None, max_examples=25)
@given(seed=st.integers(0, 2 ** 31 - 1), n_threads=st.sampled_from(
    [16, 20, 64, 256]), n_instrs=st.integers(1, 12))
def test_property_random_programs_cost_as_the_reference(seed, n_threads,
                                                         n_instrs):
    """Random straight-line programs (one- and two-word loads, twiddle
    loads, stores, vector and scalar compute) cost the same on the port as
    on the reference, on four memories."""
    rng = np.random.default_rng(seed)
    progs = [RASM.Program("rand", n_threads), PASM.Program("rand",
                                                           n_threads)]
    for _ in range(n_instrs):
        op = int(rng.integers(0, 5))
        words = int(rng.integers(1, 3))
        addrs = rng.integers(0, 4096, (words, n_threads)).astype(np.int32)
        regs = tuple(f"r{w}" for w in range(words))
        counts = {"fp": int(rng.integers(0, 4)), "int": int(rng.integers(
            0, 4))}
        for p in progs:
            if op == 0:
                p.load(regs, addrs)
            elif op == 1:
                p.load(regs, addrs, space="TW")
            elif op == 2:
                p.store(regs, addrs)
            else:
                p.compute(counts, scalar=op == 4)
    archs = ["16B", "8B-offset", "4R-2W", "4R-1W-VB"]
    want = RCE.cost_many(archs, RTrace.from_program(progs[0]))
    got = PCE.cost_many(archs, PVM.program_trace_stream(progs[1], 7),
                        device="cpu")
    assert [_asdict(c) for c in got] == [_asdict(c) for c in want]
