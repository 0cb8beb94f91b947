"""The port's controller kernels and the registry's cost API held to the
JAX reference.  ``conflict_popcount`` and ``carry_arbiter`` on CPU tensors
run their plain PyTorch versions, which must equal the reference's Pallas
kernels (run as the reference's own tests run them, interpret=True) bit
for bit over the reference tests' sweeps (tests/test_kernels.py:58-97) and
the edge cases, and accept and refuse the same shapes; their traces, block
streams and ``cost_cycles`` equal the reference's; ``row_stream_cost`` and
``register_kernel`` behave as the reference's.  The CUDA kernels are held
to the plain versions by the ``cuda`` tests of test_torch_cuda.py (and by
chip_smoke.py) on the card.  Inputs are made with numpy from fixed seeds."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import kernels as rk
from repro.core import arch as RA
from repro.core.arbiter import pack_requests as r_pack
from repro.core.conflicts import bank_onehot as r_onehot
from repro.core.cost_engine import cost_many as r_cost_many
from repro.kernels.carry_arbiter.ops import carry_arbiter as r_arbiter
from repro.kernels.carry_arbiter.ref import carry_arbiter_ref as r_arb_ref
from repro.kernels.conflict_popcount.ops import conflict_popcount as r_pop
from repro.kernels.conflict_popcount.ref import conflict_popcount_ref as r_pref
from repro_torch import kernels as pk
from repro_torch.core import arch as PA
from repro_torch.core.arbiter import pack_requests
from repro_torch.core.conflicts import bank_onehot
from repro_torch.core.cost_engine import cost_many
from repro_torch.kernels.carry_arbiter.ops import carry_arbiter
from repro_torch.kernels.carry_arbiter.ref import carry_arbiter_ref
from repro_torch.kernels.conflict_popcount.ops import conflict_popcount
from repro_torch.kernels.conflict_popcount.ref import conflict_popcount_ref


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pop_equal(banks: np.ndarray, n_banks: int) -> None:
    """The port's wrapper (its plain version on a CPU tensor) == the Pallas
    kernel, counts and cycles, bit for bit and in int32."""
    want = r_pop(jnp.asarray(banks), n_banks)
    got = conflict_popcount(torch.from_numpy(banks), n_banks)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), _np(w))


def _arb_equal(reqs: np.ndarray) -> np.ndarray:
    """The port's wrapper == the Pallas kernel: the port's int64 words hold
    the reference's uint32 words exactly."""
    want = np.asarray(r_arbiter(jnp.asarray(reqs))).astype(np.int64)
    got = carry_arbiter(torch.from_numpy(reqs))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    return want


# ------------------------------------------------------------ popcount --

@pytest.mark.parametrize("n_ops", [8, 256, 1024])
@pytest.mark.parametrize("n_banks", [4, 8, 16])
def test_popcount_sweep_bit_equal_to_pallas(n_ops, n_banks):
    banks = np.random.default_rng(n_ops + n_banks).integers(
        0, n_banks, (n_ops, 16)).astype(np.int32)
    _pop_equal(banks, n_banks)
    # the oracles agree too, and the registry runs the same function
    for g, w in zip(conflict_popcount_ref(torch.from_numpy(banks), n_banks),
                    r_pref(jnp.asarray(banks), n_banks), strict=True):
        np.testing.assert_array_equal(_np(g), _np(w))
    got = pk.get("conflict_popcount").run(f"{n_banks}B",
                                          torch.from_numpy(banks))
    want = rk.get("conflict_popcount").run(f"{n_banks}B", jnp.asarray(banks),
                                           interpret=True)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(_np(g), _np(w))


POP_EDGES = {
    # ids outside [0, n_banks), a negative one among them, count nowhere:
    # counts sum to 14, cycles 12
    "out_of_range": (np.array([[0, 1, 17, -1] + [2] * 12] * 8), 16),
    "wide_ids_b32": (np.random.default_rng(1).integers(-4, 36, (256, 16)),
                     32),
    "b12": (np.random.default_rng(2).integers(0, 12, (512, 16)), 12),
    "b6": (np.random.default_rng(3).integers(-1, 8, (256, 16)), 6),
    # fewer lanes than 16 below 256 ops: every lane counts (cycles 12)
    "lanes12": (np.zeros((8, 12), np.int64), 16),
    # more lanes than 16: the reference kernel counts the first 16
    "lanes40": (np.random.default_rng(4).integers(0, 16, (8, 40)), 16),
    "lanes17": (np.random.default_rng(5).integers(0, 8, (200, 17)), 8),
}


@pytest.mark.parametrize("case", list(POP_EDGES))
def test_popcount_edge_cases_bit_equal_to_pallas(case):
    banks, n_banks = POP_EDGES[case]
    _pop_equal(banks, n_banks)
    if case == "out_of_range":
        counts, cycles = conflict_popcount(torch.from_numpy(banks), n_banks)
        assert counts.sum(1).tolist() == [14] * 8
        assert cycles.tolist() == [12] * 8
    if case == "lanes12":
        assert conflict_popcount(torch.from_numpy(banks))[1].tolist() == \
            [12] * 8


@pytest.mark.parametrize("shape,n_banks", [
    ((300, 16), 16), ((512, 12), 16), ((0, 16), 16), ((8, 0), 16),
    ((8, 16), 0), ((16,), 16)])
def test_popcount_refuses_what_the_reference_refuses(shape, n_banks):
    banks = np.zeros(shape, np.int32)
    with pytest.raises((AssertionError, ValueError, TypeError,
                        ZeroDivisionError)):
        r_pop(jnp.asarray(banks), n_banks)
    with pytest.raises(ValueError):
        conflict_popcount(torch.from_numpy(banks), n_banks)


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(-3, 20), min_size=16, max_size=16))
def test_popcount_property_equals_pallas(lanes):
    banks = np.array([lanes], np.int32)
    _pop_equal(banks, 16)
    counts, cycles = conflict_popcount(torch.from_numpy(banks), 16)
    assert int(counts.sum()) == sum(0 <= b < 16 for b in lanes)
    assert int(cycles[0]) == max([lanes.count(b) for b in range(16)])


def test_popcount_bank_count_follows_the_memory():
    """``n_banks`` defaults to the memory's banks, or to a VB memory's write
    banks; a multi-port memory without them raises, as in the reference."""
    banks = np.random.default_rng(6).integers(0, 8, (64, 16)).astype(
        np.int32)
    for name in ("8B-offset", "4R-1W-VB"):
        got = pk.get("conflict_popcount").run(name, torch.from_numpy(banks))
        want = rk.get("conflict_popcount").run(name, jnp.asarray(banks),
                                               interpret=True)
        assert got[0].shape == tuple(want[0].shape)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(_np(g), _np(w))
    for k in (pk, rk):
        with pytest.raises(NotImplementedError):
            k.get("conflict_popcount").run("4R-1W", banks)
        with pytest.raises(NotImplementedError):
            k.get("conflict_popcount").reference("4R-1W", banks)
    got = pk.get("conflict_popcount").run("4R-1W", torch.from_numpy(banks),
                                          n_banks=8)
    np.testing.assert_array_equal(got[1].numpy(), _np(r_pop(
        jnp.asarray(banks), 8)[1]))


# ------------------------------------------------------------- arbiter --

@pytest.mark.parametrize("n_ops,n_banks", [(8, 16), (128, 16), (256, 8)])
def test_arbiter_sweep_bit_equal_to_pallas(n_ops, n_banks):
    banks = np.random.default_rng(7).integers(0, n_banks, (n_ops, 16))
    reqs = pack_requests(bank_onehot(torch.from_numpy(banks),
                                     n_banks).transpose(-1, -2)).numpy()
    r_reqs = r_pack(jnp.swapaxes(r_onehot(jnp.asarray(banks), n_banks),
                                 -1, -2))
    np.testing.assert_array_equal(reqs, np.asarray(r_reqs))
    want = _arb_equal(reqs)
    np.testing.assert_array_equal(
        carry_arbiter_ref(torch.from_numpy(reqs)).numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(r_arb_ref(jnp.asarray(reqs, jnp.uint32))), want)
    got = pk.get("carry_arbiter").run("16B", torch.from_numpy(reqs))
    np.testing.assert_array_equal(got.numpy(), want)


ARB_EDGES = {
    # all 16 lanes on bank 0: one distinct lane a cycle, 16 cycles
    "drain": np.array([[0xFFFF] + [0] * 15] * 8, np.int64),
    # more than 16 requests: 0x1 … 0x8000 granted, the rest stays
    "full_word": np.full((4, 3), 0xFFFFFFFF, np.int64),
    "random_32bit": np.random.default_rng(8).integers(0, 2 ** 32, (128, 16)),
    "int32_minus_one": np.full((4, 12), -1, np.int32),
    "ops384_b6": np.random.default_rng(9).integers(0, 2 ** 16, (384, 6)),
    "ops3_b5": np.random.default_rng(10).integers(0, 2 ** 16, (3, 5)),
}


@pytest.mark.parametrize("case", list(ARB_EDGES))
def test_arbiter_edge_cases_bit_equal_to_pallas(case):
    grants = _arb_equal(ARB_EDGES[case])
    if case == "drain":
        bank0 = grants[0, :, 0]
        assert (np.bitwise_count(bank0) == 1).all()
        assert np.bitwise_or.reduce(bank0) == 0xFFFF
    if case == "full_word":
        assert grants[0, :, 0].tolist() == [1 << c for c in range(16)]


@pytest.mark.parametrize("shape", [(200, 16), (200, 4), (0, 16), (8, 0),
                                   (16,)])
def test_arbiter_refuses_what_the_reference_refuses(shape):
    reqs = np.zeros(shape, np.uint32)
    with pytest.raises((AssertionError, ValueError, ZeroDivisionError)):
        r_arbiter(jnp.asarray(reqs))
    with pytest.raises(ValueError):
        carry_arbiter(torch.from_numpy(reqs.astype(np.int64)))


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(0, 2 ** 32 - 1), min_size=1, max_size=32))
def test_arbiter_property_equals_pallas(words):
    grants = _arb_equal(np.array([words], np.int64))
    # a word with k set bits grants its lowest min(k, 16) bits, in order
    for b, w in enumerate(words):
        low = [1 << i for i in range(32) if w >> i & 1][:16]
        assert grants[0, :, b].tolist() == low + [0] * (16 - len(low))


# -------------------------------------------------------------- traces --

def _same_trace(got, want):
    for f in ("addrs", "kinds", "instr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    gm, wm = got.mask, want.mask
    assert (gm is None) == (wm is None)
    if gm is not None:
        np.testing.assert_array_equal(gm, wm)


def _controller_inputs():
    rng = np.random.default_rng(11)
    return [("conflict_popcount", rng.integers(0, 16, (37, 16))),
            ("carry_arbiter",
             rng.integers(1, 2 ** 16, (23, 16)).astype(np.uint32))]


def test_traces_equal_the_reference():
    """``address_trace`` field for field, from numpy and from tensors, and
    the reference tests' own pins (tests/test_trace.py:209-228)."""
    for name, x in _controller_inputs():
        want = rk.get(name).address_trace("16B", x)
        _same_trace(pk.get(name).address_trace("16B", x), want)
        _same_trace(pk.get(name).address_trace(
            "16B", torch.from_numpy(x.astype(np.int64))), want)
    banks = np.random.default_rng(0).integers(0, 16, (32, 16))
    t = pk.get("conflict_popcount").address_trace("16B", banks)
    _, cycles = conflict_popcount(torch.from_numpy(banks), 16)
    assert (PA.get("16B").cost(t, device="cpu").load_cycles
            == int(cycles.sum()) + 40)      # + one 16B read overhead
    banks = np.random.default_rng(1).integers(0, 16, (8, 16))
    reqs = pack_requests(bank_onehot(torch.from_numpy(banks),
                                     16).transpose(-1, -2))
    t = pk.get("carry_arbiter").address_trace("16B", reqs)
    np.testing.assert_array_equal(t.addrs, banks)
    assert t.mask.all()


@pytest.mark.parametrize("name", ["conflict_popcount", "carry_arbiter"])
def test_trace_blocks_stream_equals_dense(name):
    """Streamed == dense at block_ops 1/7/64 and unblocked, on four
    memories, priced equal to the reference (tests/test_cost_engine.py:
    257-280)."""
    x = dict(_controller_inputs())[name]
    names = ("16B", "8B-offset", "4R-2W", "4R-1W-VB")
    archs = [PA.get(n) for n in names]
    k = pk.get(name)
    dense_t = k.address_trace(archs[0], x)
    assert dense_t.n_instructions == 1
    dense = cost_many(archs, dense_t, device="cpu")
    want = r_cost_many([RA.get(n) for n in names],
                       rk.get(name).address_trace("16B", x))
    assert [dataclasses.asdict(c) for c in dense] == [
        dataclasses.asdict(c) for c in want]
    for bo in (1, 7, 64, None):
        got = cost_many(archs, k.trace_blocks(archs[0], x, block_ops=bo),
                        device="cpu")
        assert got == dense, (name, bo)


def test_stream_generator_rejects_nonpositive_block_ops():
    with pytest.raises(ValueError):
        list(pk.get("carry_arbiter").trace_blocks(
            "16B", np.ones((4, 16), np.uint32), block_ops=0).blocks())


# ------------------------------------------------------------ cost API --

def _cost_cases():
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 512, 200)
    table = np.zeros((512, 8), np.float32)
    return [("conflict_popcount", (rng.integers(0, 16, (37, 16)),)),
            ("carry_arbiter",
             (rng.integers(1, 2 ** 16, (23, 16)).astype(np.uint32),)),
            ("banked_gather", (table, idx)),
            ("banked_scatter", (table, idx, np.zeros((200, 8), np.float32))),
            ("banked_transpose", (np.zeros((32, 32), np.float32),))]


@pytest.mark.parametrize("arch", [a.name for a in RA.PAPER_ARCHITECTURES])
def test_cost_cycles_equal_the_reference(arch):
    assert arch in [a.name for a in PA.PAPER_ARCHITECTURES]
    for name, args in _cost_cases():
        want = rk.get(name).cost_cycles(arch, *args)
        assert pk.get(name).cost_cycles(arch, *args, device="cpu") == want, \
            (name, arch)


def test_row_stream_cost_equals_the_reference():
    from repro.kernels.registry import row_stream_cost as r_row_cost
    from repro_torch.kernels.registry import row_stream_cost
    idx = np.arange(100) * 3
    for name in ("16B", "8B-offset", "4R-1W"):
        for is_write in (False, True):
            want = r_row_cost(RA.get(name), idx, is_write)
            assert row_stream_cost(PA.get(name), idx, is_write,
                                   device="cpu") == want
            assert row_stream_cost(PA.get(name), torch.from_numpy(idx),
                                   is_write, device="cpu") == want


def test_register_kernel_matches_the_reference():
    """The decorator registers its function as the kernel entry point; a
    traced kernel prices its trace, a cost-only kernel answers with its
    cost, a kernel with neither raises — in both packages."""
    from repro.kernels.registry import _KERNELS as r_registered
    from repro.kernels.registry import row_stream_trace as r_trace
    from repro_torch.kernels.registry import _KERNELS as p_registered
    from repro_torch.kernels.registry import row_stream_trace as p_trace
    idx = np.arange(64) * 5
    made = {}
    try:
        for pkg, trace in ((rk, r_trace), (pk, p_trace)):
            @pkg.register_kernel("test_rows", ref=lambda arch, x: x,
                                 trace=lambda arch, x, t=trace: t(x),
                                 description="rows")
            def rows(arch, x):
                return x[::-1]

            @pkg.register_kernel("test_costed", ref=lambda arch, x: x,
                                 cost=lambda arch, x: 7 * len(x))
            def costed(arch, x):
                return x

            @pkg.register_kernel("test_bare", ref=lambda arch, x: x)
            def bare(arch, x):
                return x
            made[pkg] = (rows, costed, bare)
        for pkg in (rk, pk):
            rows, costed, bare = made[pkg]
            assert pkg.get("test_rows") is rows
            assert isinstance(rows, pkg.Kernel)
            assert rows.description == "rows"
            assert list(rows.run("16B", [1, 2, 3])) == [3, 2, 1]
            assert costed.cost_cycles("16B", idx) == 7 * 64
            with pytest.raises(NotImplementedError):
                bare.cost_cycles("16B", idx)
        for name in ("16B", "8B-offset", "4R-2W"):
            assert (made[pk][0].cost_cycles(name, idx, device="cpu")
                    == made[rk][0].cost_cycles(name, idx))
    finally:
        for registered in (r_registered, p_registered):
            for name in ("test_rows", "test_costed", "test_bare"):
                registered.pop(name, None)


# ----------------------------------------------------------- the slice --

def test_bench_rows_equal_the_reference_kernels():
    """Each row of ``python -m repro_torch.bench.kernel_bench`` computes on
    the host what the reference's kernel computes on the same inputs: the
    integer kernels and the row moves bit for bit, the FFT within
    2e-3·max|X| (tests/test_kernels.py:153-154)."""
    from repro.kernels.banked_gather.ops import banked_gather as r_gather
    from repro.kernels.banked_gather.ops import to_banked_layout
    from repro.kernels.banked_transpose.ops import banked_transpose as r_tr
    from repro.kernels.fft_stage.ops import fft4096_radix4 as r_fft
    from repro.kernels.moe_dispatch.ops import moe_dispatch_positions as r_moe
    from repro_torch.bench import kernel_bench as KB
    from repro_torch.core.arch import BankedLayout
    cases = KB.cases("cpu")
    assert [c[0] for c in cases] == [
        "banked_gather_1024x512_r256", "conflict_popcount_4096ops",
        "carry_arbiter_1024ops", "moe_dispatch_8192req_e16",
        "fft4096_radix4_b4", "banked_transpose_512"]
    got = {name: kern(*args) for name, kern, _, args, _ in cases}
    inputs = {name: args for name, _, _, args, _ in cases}
    table, idx, n_banks = inputs["banked_gather_1024x512_r256"]
    logical = BankedLayout(n_banks).from_banked(table)
    want = r_gather(to_banked_layout(jnp.asarray(logical.numpy()), n_banks),
                    jnp.asarray(idx.numpy()), n_banks)
    np.testing.assert_array_equal(got["banked_gather_1024x512_r256"].numpy(),
                                  np.asarray(want))
    banks, n_banks = inputs["conflict_popcount_4096ops"]
    for g, w in zip(got["conflict_popcount_4096ops"],
                    r_pop(jnp.asarray(banks.numpy()), n_banks), strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    (reqs,) = inputs["carry_arbiter_1024ops"]
    np.testing.assert_array_equal(
        got["carry_arbiter_1024ops"].numpy(),
        np.asarray(r_arbiter(jnp.asarray(reqs.numpy().astype(np.uint32))))
        .astype(np.int64))
    experts, n_experts, capacity = inputs["moe_dispatch_8192req_e16"]
    for g, w in zip(got["moe_dispatch_8192req_e16"],
                    r_moe(jnp.asarray(experts.numpy()), n_experts, capacity),
                    strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    (x,) = inputs["fft4096_radix4_b4"]
    want = np.asarray(r_fft(jnp.asarray(x.numpy())))
    assert np.abs(got["fft4096_radix4_b4"].numpy() - want).max() <= \
        2e-3 * np.abs(want).max()
    (m,) = inputs["banked_transpose_512"]
    np.testing.assert_array_equal(got["banked_transpose_512"].numpy(),
                                  np.asarray(r_tr(jnp.asarray(m.numpy()))))
