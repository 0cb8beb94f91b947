"""Two-level banked memories in the port (``memsim.two_level``,
``TwoLevelBankedMemory``, the ``{O}x{I}B[-map][-g{G}]`` names and their
lowering) held to the JAX reference: the same names accepted and refused,
the same specs, flat bank ids, per-op cycles, controller overheads and
lowered parameter rows, on inputs made from a numpy seed."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arch as RA
from repro.core import cost_engine as RCE
from repro.core import memsim as RM
from repro_torch.core import arch as PA
from repro_torch.core import controllers as PCTL
from repro_torch.core import cost_engine as PCE
from repro_torch.core import memsim as PM
from repro_torch.core.trace import AddressTrace as PTrace

RNG = np.random.default_rng(26)
ADDRS = np.concatenate([np.arange(2048), RNG.integers(0, 2**30, 2048)]
                       ).astype(np.int32).reshape(-1, 16)

#: every shape of two-level name the reference's parser meets: defaults,
#: granules, every map, non-pow2 inner levels, and the refusals (outer < 2,
#: -g0, the -g{inner} alias, xor/fold on a non-pow2 inner, unknown maps)
NAMES = ["4x4B", "2x8B", "4x4B-g64", "2x8B-g32", "4x3B", "3x4B", "8x2B-g1",
         "2x16B-xor", "4x4B-fold-g8", "2x8B-offset", "2x6B-offset-g5",
         "5x3B-g7", "2x12B", "64x1B",
         "1x8B", "0x8B", "4x4B-g0", "4x4B-g4", "2x8B-g8", "4x3B-xor",
         "2x6B-fold", "4x0B", "2x8B-banana", "2x8B-s2", "2x8B-bcast",
         "4x4B-offset-g4"]
#: the accepted ones, priced below
TWO_LEVEL = [n for n in NAMES if n in (
    "4x4B", "2x8B", "4x4B-g64", "2x8B-g32", "4x3B", "3x4B", "8x2B-g1",
    "2x16B-xor", "4x4B-fold-g8", "2x8B-offset", "2x6B-offset-g5", "5x3B-g7",
    "2x12B", "64x1B")]


def _outcome(get, name):
    """A name's resolved spec (as a dict, the degraded field included), or
    the exception type its lookup raises."""
    try:
        return dataclasses.asdict(get(name).spec)
    except (KeyError, ValueError, NotImplementedError) as e:
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("name", NAMES)
def test_two_level_names_accept_and_refuse_as_the_reference(name):
    want = _outcome(RA.get, name)
    assert _outcome(PA.get, name) == want
    assert (name in TWO_LEVEL) == isinstance(want, dict)


@pytest.mark.parametrize("outer,inner,granule,mapping", [
    (4, 4, None, "lsb"), (4, 4, 64, "lsb"), (2, 8, 32, "lsb"),
    (4, 3, None, "lsb"), (2, 16, 4, "xor"), (3, 8, 5, "offset")])
def test_two_level_spec_equals_the_reference(outer, inner, granule, mapping):
    got = PM.two_level(outer, inner, granule, mapping)
    want = dataclasses.asdict(RM.two_level(outer, inner, granule, mapping))
    assert dataclasses.asdict(got) == want
    assert got.is_two_level and got.total_banks == outer * inner
    assert PA.from_spec(got).name == got.name
    assert isinstance(PA.resolve(got), PA.TwoLevelBankedMemory)


@pytest.mark.parametrize("args", [(1, 8, None), (0, 4, None), (4, 4, 0)])
def test_two_level_constructor_refuses_as_the_reference(args):
    with pytest.raises(ValueError):
        RM.two_level(*args)
    with pytest.raises(ValueError):
        PM.two_level(*args)


def test_single_level_specs_keep_their_fields():
    for spec in PM.PAPER_MEMORIES:
        assert not spec.is_two_level
        assert spec.outer_banks == spec.outer_granule == 0
        assert spec.total_banks == (spec.n_banks if spec.is_banked else 0)


def test_registry_and_extended_lattice_equal_the_reference():
    assert sorted(PA.names()) == sorted(RA.names())
    assert len(PA.names()) == 14
    assert [a.name for a in PA.EXTENDED_LATTICE_ARCHITECTURES] == [
        a.name for a in RA.EXTENDED_LATTICE_ARCHITECTURES]
    for name in ("4x4B-g64", "2x8B-g32", "4x3B"):
        a = PA.get(name)
        assert isinstance(a, PA.TwoLevelBankedMemory) and a.layout is None
        assert a is PA.get(name)          # registered, not re-parsed


@pytest.mark.parametrize("name", TWO_LEVEL)
def test_banks_of_equal_the_reference(name):
    got = PA.get(name).banks_of(torch.from_numpy(ADDRS))
    want = np.asarray(RA.get(name).banks_of(jnp.asarray(ADDRS)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.max()) < PA.get(name).total_banks


@pytest.mark.parametrize("name", TWO_LEVEL)
@pytest.mark.parametrize("is_write", [False, True])
def test_op_cycles_and_overheads_equal_the_reference(name, is_write):
    p, r = PA.get(name), RA.get(name)
    mask = RNG.random(ADDRS.shape) < 0.7
    for m in (None, mask):
        got = p.op_cycles(torch.from_numpy(ADDRS),
                          None if m is None else torch.from_numpy(m),
                          is_write)
        want = r.op_cycles(jnp.asarray(ADDRS),
                           None if m is None else jnp.asarray(m), is_write)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (p._instruction_overhead(is_write)
            == r._instruction_overhead(is_write))
    assert (p.instruction_cycles(torch.from_numpy(ADDRS), is_write)
            == r.instruction_cycles(ADDRS, is_write))


def test_overheads_are_charged_by_the_flat_bank_count():
    """A 4x4B arbitrates over 16 banks: its controllers cost a 16B's, not
    a 4B's, in the lowered table and on the architecture."""
    t = PCE.lower_archs(["4x4B", "16B", "4B"])
    np.testing.assert_array_equal(t.overheads[0], t.overheads[1])
    assert (t.overheads[0] != t.overheads[2]).any()
    assert tuple(t.overheads[0]) == (PCTL.read_overhead(16),
                                     PCTL.write_overhead(16))
    assert PA.get("4x4B")._instruction_overhead(True) == PCTL.write_overhead(16)


@pytest.mark.parametrize("names", [
    ("4x4B-g64", "2x8B-g32", "4x3B"),
    ("16B", "4B-offset", "4R-2W", "12B", "6B-offset", "4x4B-g64",
     "2x8B-g32", "4x3B"),
    tuple(TWO_LEVEL),
    ("16B", "8B-xor", "4R-1W-VB")])
def test_lowered_rows_equal_the_reference(names):
    p, r = PCE.lower_archs(names), RCE.lower_archs(names)
    np.testing.assert_array_equal(p.params, r.params)
    np.testing.assert_array_equal(p.overheads, r.overheads)
    assert ((p.need_uniq, p.need_mod, p.need_two_level)
            == (r.need_uniq, r.need_mod, r.need_two_level))
    assert p.need_two_level == any(PA.get(n).spec.is_two_level
                                   for n in names)


@pytest.mark.parametrize("n_ops", [16, 64])
def test_default_granule_equals_flat(n_ops):
    """4x4B (granule 4) factors addresses as a flat 16B lsb map does, and
    both pay 16 banks' overheads: the whole TraceCost is equal."""
    rng = np.random.default_rng(13 + n_ops)
    addrs = rng.integers(0, 4096, (n_ops, 16)).astype(np.int32)
    kinds = rng.integers(0, 3, n_ops).astype(np.int8)
    instr = np.sort(rng.integers(0, max(1, n_ops // 3), n_ops))
    t = PTrace(addrs, kinds, instr, rng.random((n_ops, 16)) > 0.25)
    two, flat = PA.get("4x4B"), PA.get("16B")
    assert two.spec.total_banks == 16
    assert (PCE.cost_many([two], t, device="cpu")
            == PCE.cost_many([flat], t, device="cpu"))
    assert two._cost_loop(t, device="cpu") == flat._cost_loop(t, device="cpu")


@pytest.mark.parametrize("name", ["4x4B", "2x8B-g32", "4x3B"])
def test_serving_traces_on_two_level_memories_equal_the_reference(name):
    """A two-level memory has no flat layout: the KV allocator falls back
    to its canonical pool, as the reference's does, and the trace (and its
    pricing) is the reference's."""
    from repro.serving.kvcache import simulate_serving_trace as r_sim
    from repro_torch.serving.kvcache import simulate_serving_trace as p_sim
    got = p_sim(name, 3, 20, 5, page_len=8, n_kv_layers=2, device="cpu")
    want = r_sim(name, 3, 20, 5, page_len=8, n_kv_layers=2)
    for f in ("addrs", "kinds", "instr", "mask"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert (dataclasses.asdict(PCE.cost_many([name], got, device="cpu")[0])
            == dataclasses.asdict(RCE.cost_many([name], want)[0]))
