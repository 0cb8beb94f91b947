"""The port's core (repro_torch.core) held bit-equal to the JAX reference:
bank maps, the bank-major row layout, conflict counting, the carry-chain
arbiter and the architecture registry.  Inputs are numpy, seeded, and go
through both packages."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arbiter as RArb
from repro.core import arch as RA
from repro.core import conflicts as RC
from repro.core import memsim as RM
from repro.core.bankmap import bank_of as r_bank_of
from repro_torch.core import arbiter as PArb
from repro_torch.core import arch as PA
from repro_torch.core import conflicts as PC
from repro_torch.core import memsim as PM
from repro_torch.core.bankmap import bank_of as p_bank_of

RNG = np.random.default_rng(0)
ADDRS = np.concatenate([np.arange(4096), RNG.integers(0, 2**30, 4096)]
                       ).astype(np.int32)
MAPS = ([(m, b, {}) for m in ("lsb", "xor", "fold") for b in (4, 8, 16, 32)]
        + [("offset", b, {"shift": s}) for b in (4, 8, 16) for s in (1, 2)]
        + [(m, b, kw) for b in (6, 12) for m, kw in
           (("lsb", {}), ("offset", {"shift": 1}), ("offset", {"shift": 2}))])


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mapping,n_banks,kw", MAPS)
def test_bank_of_bit_equal(mapping, n_banks, kw):
    want = np.asarray(r_bank_of(jnp.asarray(ADDRS), n_banks, mapping, **kw))
    got = p_bank_of(_t(ADDRS), n_banks, mapping, **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mapping,n_banks,kw", MAPS)
def test_row_layout_round_trips_bit_equal(mapping, n_banks, kw):
    """bank_slot_of / physical_row_of / logical_row_of / BankedLayout agree
    with the reference, and logical_row(bank_slot(r)) == r."""
    shift = kw.get("shift", 1)
    n_rows = n_banks * 64
    r = np.arange(n_rows, dtype=np.int32)
    wb, ws = RA.bank_slot_of(jnp.asarray(r), n_banks, mapping, shift)
    gb, gs = PA.bank_slot_of(_t(r), n_banks, mapping, shift)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    back = PA.logical_row_of(gb, gs, n_banks, mapping, shift)
    np.testing.assert_array_equal(back.numpy(), r)
    np.testing.assert_array_equal(
        PA.physical_row_of(_t(r), n_banks, 64, mapping, shift).numpy(),
        np.asarray(RA.physical_row_of(jnp.asarray(r), n_banks, 64, mapping,
                                      shift)))
    lay_p = PA.BankedLayout(n_banks, mapping, shift)
    lay_r = RA.BankedLayout(n_banks, mapping, shift)
    phys = lay_p.physical_rows(n_rows, device="cpu").numpy()
    np.testing.assert_array_equal(phys, np.asarray(lay_r.physical_rows(
        n_rows)))
    np.testing.assert_array_equal(np.sort(phys), r)       # a permutation
    table = RNG.standard_normal((n_rows, 3)).astype(np.float32)
    banked = lay_p.to_banked(_t(table))
    np.testing.assert_array_equal(
        banked.numpy(), np.asarray(lay_r.to_banked(jnp.asarray(table))))
    np.testing.assert_array_equal(lay_p.from_banked(banked).numpy(), table)


@pytest.mark.parametrize("n_banks", [4, 6, 16])
def test_grant_positions_and_bank_counts_bit_equal(n_banks):
    banks = RNG.integers(0, n_banks, (64, 16)).astype(np.int32)
    mask = RNG.random((64, 16)) < 0.7
    for m in (None, mask):
        rm = None if m is None else jnp.asarray(m.astype(np.int32))
        pm = None if m is None else _t(m.astype(np.int32))
        np.testing.assert_array_equal(
            PArb.grant_positions(_t(banks), n_banks, pm).numpy(),
            np.asarray(RArb.grant_positions(jnp.asarray(banks), n_banks,
                                            rm)))
        np.testing.assert_array_equal(
            PC.bank_counts(_t(banks), n_banks, pm).numpy(),
            np.asarray(RC.bank_counts(jnp.asarray(banks), n_banks, rm)))
        np.testing.assert_array_equal(
            PC.max_conflicts(_t(banks), n_banks, pm).numpy(),
            np.asarray(RC.max_conflicts(jnp.asarray(banks), n_banks, rm)))


def test_arbiter_words_bit_equal_to_uint32():
    """The int64-with-mask request words equal the reference's uint32
    words, including v = 0 and the top bit."""
    v = np.concatenate([[0, 1, 2**31, 2**32 - 1, 0x80000001],
                        RNG.integers(0, 2**32, 256)]).astype(np.uint32)
    rv, pv = jnp.asarray(v), _t(v.astype(np.int64))
    for _ in range(33):
        rv, rg = RArb.arbiter_step(rv)
        pv, pg = PArb.arbiter_step(pv)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv, np.int64))
        np.testing.assert_array_equal(pg.numpy(), np.asarray(rg, np.int64))
    bits = (RNG.random((32, 16)) < 0.5).astype(np.int32)
    np.testing.assert_array_equal(
        PArb.pack_requests(_t(bits)).numpy(),
        np.asarray(RArb.pack_requests(jnp.asarray(bits)), np.int64))
    np.testing.assert_array_equal(
        PArb.unpack_grants(_t(v.astype(np.int64)), 32).numpy(),
        np.asarray(RArb.unpack_grants(jnp.asarray(v), 32)))


@pytest.mark.parametrize("n_banks", [4, 8, 16])
def test_arbitrate_schedule_bit_equal(n_banks):
    for _ in range(8):
        banks = RNG.integers(0, n_banks, 16).astype(np.int32)
        ws, wc = RArb.arbitrate_schedule(jnp.asarray(banks), n_banks)
        gs, gc = PArb.arbitrate_schedule(_t(banks), n_banks)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
        assert int(gc) == int(wc)
        np.testing.assert_array_equal(
            PArb.output_mux_controls(gs).numpy(),
            np.asarray(RArb.output_mux_controls(ws)))


def test_first_occurrence_and_broadcast_bit_equal():
    addrs = RNG.integers(0, 24, (128, 16)).astype(np.int32)
    mask = RNG.random((128, 16)) < 0.6
    banks = addrs % 8
    for m in (None, mask):
        rm = None if m is None else jnp.asarray(m)
        pm = None if m is None else _t(m)
        np.testing.assert_array_equal(
            PC.first_occurrence(_t(addrs), pm).numpy(),
            np.asarray(RC.first_occurrence(jnp.asarray(addrs), rm)))
        np.testing.assert_array_equal(
            PC.max_conflicts_broadcast(_t(addrs), _t(banks), 8, pm).numpy(),
            np.asarray(RC.max_conflicts_broadcast(
                jnp.asarray(addrs), jnp.asarray(banks), 8, rm)))


NAMES = ["16B", "16B-offset", "16B-offset-s2", "16B-xor", "16B-fold",
         "8B", "8B-offset", "4B", "4B-offset", "32B-xor", "12B", "6B-offset",
         "16B-bcast", "16B-xor-bcast", "4R-1W", "4R-2W", "4R-1W-VB", "8R-1W"]


@pytest.mark.parametrize("name", NAMES)
def test_arch_registry_and_op_cycles_bit_equal(name):
    """Every constructible name parses to the reference's spec fields and
    the same per-op cycles (masked and unmasked), with the same
    per-instruction overheads."""
    p, r = PA.get(name), RA.get(name)
    for f in ("kind", "name", "n_banks", "mapping", "map_shift", "broadcast",
              "read_ports", "write_ports", "vb_write_banks", "fmax_mhz"):
        assert getattr(p.spec, f) == getattr(r.spec, f), f
    assert (p.layout is None) == (r.layout is None)
    addrs = RNG.integers(0, 4096, (64, 16)).astype(np.int32)
    mask = RNG.random((64, 16)) < 0.75
    for is_write in (False, True):
        for m in (None, mask):
            got = p.op_cycles(_t(addrs), None if m is None else _t(m),
                              is_write)
            want = r.op_cycles(jnp.asarray(addrs),
                               None if m is None else jnp.asarray(m),
                               is_write)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (p.instruction_cycles(_t(addrs), is_write)
                == r.instruction_cycles(addrs, is_write))


def test_arch_registry_lists_and_refusals():
    assert [a.name for a in PA.PAPER_ARCHITECTURES] == [
        a.name for a in RA.PAPER_ARCHITECTURES]
    assert [m.name for m in PM.PAPER_MEMORIES] == [
        m.name for m in RM.PAPER_MEMORIES]
    assert set(PA.names()) <= set(RA.names())
    for bad in ("0B", "12B-xor", "16B-s2", "0R-1W", "banana"):
        with pytest.raises(KeyError):
            PA.get(bad)
    # two-level names and degraded variants resolve to the reference's
    # spec, field for field; degraded variants are never registered
    for two in ("4x4B-g64", "2x8B-g32"):
        assert dataclasses.asdict(PA.get(two).spec) == dataclasses.asdict(
            RA.get(two).spec)
    for deg in ("16B-xor!d3", "16B!d1+2"):
        assert dataclasses.asdict(PA.get(deg).spec) == dataclasses.asdict(
            RA.get(deg).spec)
        assert deg not in PA.names()


def test_trace_builder_and_chunking_equal_the_reference():
    """TraceBuilder instruction grouping and compute accounting, concat,
    and iter_op_chunks continuation marks match the reference."""
    from repro.core import trace as RT
    from repro_torch.core import trace as PT
    addrs = RNG.integers(0, 512, 100)
    mask = RNG.random(100) < 0.8
    builds = []
    for T in (RT, PT):
        b = T.TraceBuilder(n_threads=64)
        b.load(addrs[:40]).compute({"fp": 3, "int": 1})
        b.store(addrs[40:], mask=mask[40:]).load(addrs[:16], space="TW")
        b.compute({"other": 2}, scalar=True)
        builds.append(b.build(meta={"what": "t"}))
    r, p = builds
    for f in ("addrs", "kinds", "instr", "mask"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f))
    assert (p.compute_cycles, p.op_counts, p.n_instructions) == (
        r.compute_cycles, r.op_counts, r.n_instructions)
    for block_ops in (1, 3, None):
        rc = list(RT.iter_op_chunks(addrs, "load", mask, block_ops))
        pc = list(PT.iter_op_chunks(addrs, "load", mask, block_ops))
        assert [c.meta for c in pc] == [c.meta for c in rc]
        for a, b in zip(pc, rc):
            np.testing.assert_array_equal(a.addrs, b.addrs)
            np.testing.assert_array_equal(a.mask, b.mask)
