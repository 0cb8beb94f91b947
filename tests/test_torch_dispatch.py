"""The port's MoE dispatch held to the JAX reference.

``moe_dispatch_positions`` on CPU tensors runs its plain PyTorch version,
which must equal the reference's Pallas kernel (run as the reference's own
tests run it, interpret=True) and its oracle bit for bit, ``pos`` and
``kept`` (tolerance 0: integers), over the reference tests' sweep
(tests/test_kernels.py:103-123) and the edge cases, and refuse what the
reference refuses; its trace, block stream and ``cost_cycles`` equal the
reference's.  ``repro_torch.core.dispatch`` equals ``repro.core.dispatch``
field for field, with and without a mask, over the cases of
tests/test_dispatch.py.  The CUDA kernel is held to the plain version by
the ``cuda`` tests of test_torch_cuda.py (and by chip_smoke.py) on the
card.  Inputs are made with numpy from fixed seeds."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.dispatch as RD
import repro_torch.core.dispatch as PD
from repro import kernels as rk
from repro.core import arch as RA
from repro.core.cost_engine import cost_many as r_cost_many
from repro.kernels.moe_dispatch.ops import moe_dispatch_positions as r_moe
from repro.kernels.moe_dispatch.ref import moe_dispatch_ref as r_moe_ref
from repro_torch import core as PC
from repro_torch import kernels as pk
from repro_torch.core import arch as PA
from repro_torch.core.arbiter import grant_positions
from repro_torch.core.cost_engine import cost_many
from repro_torch.kernels.moe_dispatch.ops import (moe_dispatch_plain,
                                                  moe_dispatch_positions)
from repro_torch.kernels.moe_dispatch.ref import moe_dispatch_ref

INT32 = np.iinfo(np.int32)


def _moe_equal(ids: np.ndarray, n_experts: int, capacity: int):
    """The port's wrapper (its plain version on a CPU tensor) == the Pallas
    kernel == both oracles: int32 positions and bool kept, bit for bit."""
    got = moe_dispatch_positions(torch.from_numpy(ids), n_experts, capacity)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.bool
    wants = (r_moe(jnp.asarray(ids), n_experts, capacity),
             r_moe_ref(jnp.asarray(ids), n_experts, capacity),
             moe_dispatch_ref(torch.from_numpy(ids), n_experts, capacity))
    for want in wants:
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return got


# ---------------------------------------------------------- the kernel --

@pytest.mark.parametrize("r,e,cap", [(512, 16, 40), (1024, 8, 100),
                                     (2048, 16, 16)])
def test_moe_dispatch_sweep_bit_equal_to_pallas(r, e, cap):
    ids = np.random.default_rng(r).integers(0, e, r).astype(np.int32)
    _moe_equal(ids, e, cap)
    # the registry runs the same function as the reference's registry
    got = pk.get("moe_dispatch").run("16B", torch.from_numpy(ids), e, cap)
    want = rk.get("moe_dispatch").run("16B", jnp.asarray(ids), e, cap,
                                      interpret=True)
    ref = pk.get("moe_dispatch").reference("16B", torch.from_numpy(ids), e,
                                           cap)
    for g, w, o in zip(got, want, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))


MOE_EDGES = {
    # everyone wants expert 0 across three 512-blocks: pos == arange
    "block_boundary": (np.zeros(1536, np.int32), 4, 1000),
    "r300": (np.random.default_rng(1).integers(0, 16, 300), 16, 20),
    "one_expert": (np.zeros(1024, np.int64), 1, 700),
    "e256": (np.random.default_rng(2).integers(0, 256, 2048), 256, 10),
    # more experts than the CUDA kernel counts in one pass (1024)
    "e3000": (np.random.default_rng(9).integers(-3, 3003, 2048), 3000, 2),
    # ids outside [0, E), negative ones among them: pos 0, kept iff 0 < cap
    "out_of_range": (np.random.default_rng(3).integers(-4, 20, 512), 16, 5),
    "capacity_0": (np.random.default_rng(4).integers(0, 8, 512), 8, 0),
    "capacity_above_r": (np.random.default_rng(5).integers(0, 8, 1024), 8,
                         5000),
    "capacity_int32_min": (np.random.default_rng(6).integers(0, 8, 64), 8,
                           int(INT32.min)),
    "capacity_int32_max": (np.random.default_rng(7).integers(0, 8, 64), 8,
                           int(INT32.max)),
    # no experts: every id is out of range
    "no_experts": (np.random.default_rng(8).integers(-2, 3, 100), 0, 1),
}


@pytest.mark.parametrize("case", list(MOE_EDGES))
def test_moe_dispatch_edge_cases_bit_equal_to_pallas(case):
    ids, e, cap = MOE_EDGES[case]
    pos, kept = _moe_equal(ids.astype(np.int32), e, cap)
    # int64 ids narrow to the same int32 ids (as astype(jnp.int32))
    got64 = moe_dispatch_positions(torch.from_numpy(ids.astype(np.int64)), e,
                                   cap)
    assert torch.equal(got64[0], pos) and torch.equal(got64[1], kept)
    if case == "block_boundary":
        assert pos.tolist() == list(range(1536))
    if case == "out_of_range":
        outside = (ids < 0) | (ids >= 16)
        assert outside.any() and (pos.numpy()[outside] == 0).all()
        assert kept.numpy()[outside].all()
    if case in ("capacity_0", "capacity_int32_min"):
        assert not kept.any()
    if case in ("capacity_above_r", "capacity_int32_max"):
        assert kept.all()


def test_cpu_path_launches_no_kernel():
    """A CPU tensor runs the plain version: no entry's launch count
    moves; the summed count resets to 0 and only to 0."""
    from repro_torch.kernels.moe_dispatch.ops import DISPATCH, ENTRIES
    before = [e.launches for e in ENTRIES]
    moe_dispatch_positions(torch.zeros(512, dtype=torch.int32), 16, 8)
    assert [e.launches for e in ENTRIES] == before
    assert DISPATCH.launches == sum(before)
    DISPATCH.launches = 0
    assert [e.launches for e in ENTRIES] == [0, 0, 0]
    with pytest.raises(ValueError):
        DISPATCH.launches = 3


def test_moe_dispatch_matches_the_arbiter():
    """tests/test_kernels.py:119: positions are the arbiter's grant
    positions."""
    ids = np.random.default_rng(3).integers(0, 16, 512).astype(np.int32)
    pos, _ = moe_dispatch_positions(torch.from_numpy(ids), 16, 512)
    assert torch.equal(pos, grant_positions(torch.from_numpy(ids), 16))
    assert torch.equal(pos, moe_dispatch_plain(torch.from_numpy(ids), 16,
                                               512)[0])


@pytest.mark.parametrize("shape,n_experts,capacity", [
    ((600,), 16, 8), ((1000,), 16, 8), ((0,), 16, 8), ((4, 4), 16, 8),
    ((), 16, 8), ((512,), -1, 8), ((512,), 16, 2 ** 31),
    ((512,), 16, -2 ** 31 - 1)])
def test_moe_dispatch_refuses_what_the_reference_refuses(shape, n_experts,
                                                         capacity):
    ids = np.zeros(shape, np.int32)
    with pytest.raises((AssertionError, ValueError, TypeError,
                        ZeroDivisionError, IndexError, OverflowError)):
        r_moe(jnp.asarray(ids), n_experts, capacity)
    with pytest.raises(ValueError):
        moe_dispatch_positions(torch.from_numpy(ids), n_experts, capacity)


@settings(max_examples=30, deadline=None, database=None)
@given(st.lists(st.integers(-3, 10), min_size=1, max_size=64),
       st.integers(0, 8), st.integers(-2, 40))
def test_moe_dispatch_property_equals_pallas(ids, n_experts, capacity):
    _moe_equal(np.array(ids, np.int32), n_experts, capacity)


# -------------------------------------------------- traces and pricing --

def _moe_input():
    return (np.random.default_rng(11).integers(0, 512, 1000) % 16, 16, 64)


def test_trace_equals_the_reference():
    args = _moe_input()
    want = rk.get("moe_dispatch").address_trace("16B", *args)
    for ids in (args[0], torch.from_numpy(args[0])):
        got = pk.get("moe_dispatch").address_trace("16B", ids, *args[1:])
        for f in ("addrs", "kinds", "instr", "mask"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.n_instructions == 1


def test_trace_blocks_stream_equals_dense_and_the_reference():
    """Streamed == dense at block_ops 1/7/64 and unblocked, on four
    memories, priced equal to the reference (tests/test_cost_engine.py:
    246-272)."""
    args = _moe_input()
    names = ("16B", "8B-offset", "4R-2W", "4R-1W-VB")
    archs = [PA.get(n) for n in names]
    k = pk.get("moe_dispatch")
    dense = cost_many(archs, k.address_trace(archs[0], *args), device="cpu")
    want = r_cost_many([RA.get(n) for n in names],
                       rk.get("moe_dispatch").address_trace("16B", *args))
    assert [dataclasses.asdict(c) for c in dense] == [
        dataclasses.asdict(c) for c in want]
    for bo in (1, 7, 64, None):
        got = cost_many(archs, k.trace_blocks(archs[0], *args, block_ops=bo),
                        device="cpu")
        assert got == dense, bo


@pytest.mark.parametrize("arch", ["16B", "4R-2W", "16B-offset"])
def test_cost_cycles_equal_the_reference(arch):
    args = _moe_input()
    want = rk.get("moe_dispatch").cost_cycles(arch, *args)
    assert pk.get("moe_dispatch").cost_cycles(arch, *args,
                                              device="cpu") == want


def test_registry_holds_the_seven_reference_kernels():
    """The port's registry holds every kernel package of the reference
    (its traffic kernels, attn_decode and the like, come with models/)."""
    pallas = ("banked_gather", "banked_scatter", "banked_transpose",
              "carry_arbiter", "conflict_popcount", "fft_stage",
              "moe_dispatch")
    assert pk.names() == pallas
    assert set(pallas) <= set(rk.names())
    assert pk.get("moe_dispatch").description == \
        rk.get("moe_dispatch").description


# ----------------------------------------------------- core/dispatch.py --

def _plan_equal(bank, n_banks, capacity, mask=None):
    """The port's plan == the reference's plan, field for field."""
    got = PD.banked_dispatch(torch.from_numpy(np.asarray(bank)), n_banks,
                             capacity, None if mask is None
                             else torch.from_numpy(np.asarray(mask)))
    want = RD.banked_dispatch(jnp.asarray(bank), n_banks, capacity,
                              None if mask is None else jnp.asarray(mask))
    for f in ("bank", "position", "kept", "bank_load", "max_conflicts"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.numpy().dtype == w.dtype, f
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f)
    assert got.capacity == want.capacity == capacity
    return got, want


def _roundtrip_equal(bank, n_banks, capacity, mask=None, feat=(1,)):
    """scatter_to_banks / gather_from_banks / serialization_factor on the
    same plan and payloads equal the reference's."""
    got, want = _plan_equal(bank, n_banks, capacity, mask)
    r = len(bank)
    vals = (np.arange(r * int(np.prod(feat)), dtype=np.float32) + 1.0
            ).reshape((r,) + feat)
    buf = PD.scatter_to_banks(torch.from_numpy(vals), got, n_banks, capacity)
    rbuf = RD.scatter_to_banks(jnp.asarray(vals), want, n_banks, capacity)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(rbuf))
    out, kept = PD.gather_from_banks(buf, got)
    rout, rkept = RD.gather_from_banks(rbuf, want)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(rkept))
    sf = PD.serialization_factor(got)
    assert sf.dtype == torch.float32
    assert sf.item() == float(RD.serialization_factor(want))
    return got, out


def test_positions_are_arrival_order():
    plan, _ = _plan_equal(np.array([0, 1, 0, 0, 1, 2], np.int32), 4, 8)
    assert plan.position.tolist() == [0, 0, 1, 2, 1, 0]
    assert plan.bank_load.tolist() == [3, 2, 1, 0]
    assert int(plan.max_conflicts) == 3 and bool(plan.kept.all())


def test_capacity_drops_latest_arrivals():
    plan, _ = _plan_equal(np.zeros(8, np.int32), 2, 3)
    assert plan.kept.tolist() == [True] * 3 + [False] * 5


def test_scatter_gather_roundtrip():
    plan, out = _roundtrip_equal(np.array([3, 1, 3, 0], np.int32), 4, 2)
    assert out[:, 0].tolist() == [1.0, 2.0, 3.0, 4.0]


DISPATCH_CASES = {
    "random_b8": (np.random.default_rng(0).integers(0, 8, 64), 8, 3, None),
    "masked_b8": (np.random.default_rng(1).integers(0, 8, 64), 8, 3,
                  np.random.default_rng(2).random(64) > 0.3),
    "masked_int": (np.random.default_rng(3).integers(0, 4, 32), 4, 4,
                   np.random.default_rng(4).integers(0, 2, 32)),
    # an all-false mask: nothing kept, loads 0
    "mask_off": (np.random.default_rng(5).integers(0, 4, 16), 4, 2,
                 np.zeros(16, bool)),
    # bank ids outside [0, B): the reference's drop / clamp semantics
    "out_of_range": (np.array([0, 3, -1, 5, 1, 1, 4, 2], np.int32), 4, 2,
                     None),
    "feat_2x3": (np.random.default_rng(6).integers(0, 16, 40), 16, 2, None),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_dispatch_functions_equal_the_reference(case):
    bank, n_banks, capacity, mask = DISPATCH_CASES[case]
    _roundtrip_equal(bank, n_banks, capacity, mask,
                     feat=(2, 3) if case == "feat_2x3" else (1,))


@settings(max_examples=40, deadline=None, database=None)
@given(st.lists(st.integers(0, 7), min_size=1, max_size=64),
       st.integers(1, 8), st.booleans())
def test_roundtrip_property_equals_the_reference(banks, capacity, masked):
    """tests/test_dispatch.py:38: whatever survives capacity comes back
    bit-exact, drops come back 0, no bank keeps more than the capacity —
    and every function equals the reference."""
    r = len(banks)
    mask = (np.arange(r) % 3 != 1) if masked else None
    plan, out = _roundtrip_equal(np.array(banks, np.int32), 8, capacity,
                                 mask)
    kept = plan.kept.numpy()
    np.testing.assert_array_equal(out[:, 0].numpy(),
                                  np.where(kept, np.arange(r) + 1.0, 0.0))
    for b in range(8):
        assert ((plan.bank.numpy() == b) & kept).sum() <= capacity


def test_serialization_factor_extremes():
    perm = np.arange(16, dtype=np.int32)
    assert PD.serialization_factor(PD.banked_dispatch(
        torch.from_numpy(perm), 16, 16)).item() == 1.0
    _roundtrip_equal(perm, 16, 16)
    hot = np.zeros(16, np.int32)
    assert PD.serialization_factor(PD.banked_dispatch(
        torch.from_numpy(hot), 16, 16)).item() == 16.0
    _roundtrip_equal(hot, 16, 16)


def test_core_reexports_the_dispatch_names():
    import repro.core as RC
    for name in ("DispatchPlan", "banked_dispatch", "gather_from_banks",
                 "scatter_to_banks", "serialization_factor"):
        assert name in PC.__all__ and name in RC.__all__
        assert getattr(PC, name) is getattr(PD, name)
