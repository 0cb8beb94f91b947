"""The port's cost engine (repro_torch.core.cost_engine) and serving-trace
lowering held to the JAX reference: equal TraceCosts on the paper's nine
memories at every block size, on serving points and on random traces, the
negative-remainder fold, and the BENCH_cost.json serving pins."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import arch as RA
from repro.core import cost_engine as RCE
from repro.core.trace import AddressTrace as RTrace
from repro.serving.kvcache import simulate_serving_trace as r_sim
from repro_torch.core import arch as PA
from repro_torch.core import cost_engine as PCE
from repro_torch.core.trace import AddressTrace as PTrace
from repro_torch.core.trace import TraceStream
from repro_torch.serving.kvcache import simulate_serving_stream
from repro_torch.serving.kvcache import simulate_serving_trace as p_sim

PAPER = [a.name for a in RA.PAPER_ARCHITECTURES]
LATTICE = PAPER + ["16B-xor", "16B-fold", "16B-offset-s2", "16B-bcast",
                   "32B-xor", "12B", "6B-offset"]
#: (batch, prompt_len, decode_steps, page_len)
POINTS = [(4, 16, 8, 4), (4, 12, 7, 8), (3, 20, 5, 8)]


def _same(got, want) -> bool:
    """TraceCosts of the two packages (two dataclasses) field for field."""
    return [dataclasses.asdict(c) for c in got] == [
        dataclasses.asdict(c) for c in want]


def _dense(t):
    return dict(addrs=t.addrs, kinds=t.kinds, instr=t.instr, mask=t.mask)


def test_lower_archs_rows_equal_the_reference():
    p, r = PCE.lower_archs(LATTICE), RCE.lower_archs(LATTICE)
    np.testing.assert_array_equal(p.params, r.params)
    np.testing.assert_array_equal(p.overheads, r.overheads)
    assert (p.need_uniq, p.need_mod) == (r.need_uniq, r.need_mod)


@pytest.mark.parametrize("arch", ["16B", "16B-xor", "8B-offset", "4B",
                                  "12B", "4R-2W"])
@pytest.mark.parametrize("point", POINTS)
def test_simulated_serving_traces_bit_equal(arch, point):
    b, p, d, pl = point
    got = p_sim(arch, b, p, d, page_len=pl, n_kv_layers=2, device="cpu")
    want = r_sim(arch, b, p, d, page_len=pl, n_kv_layers=2)
    for k, v in _dense(want).items():
        np.testing.assert_array_equal(_dense(got)[k], v, err_msg=k)


@pytest.mark.parametrize("block_ops", [1, 7, 64, None])
@pytest.mark.parametrize("point", POINTS[:2])
def test_cost_many_serving_equal_on_paper_memories(point, block_ops):
    """One fused pass over the 9 paper memories: the same TraceCosts as the
    reference at block sizes {1, 7, 64, n}, dense and streamed."""
    b, p, d, pl = point
    kw = dict(page_len=pl, n_kv_layers=2)
    want = RCE.cost_many(PAPER, r_sim("16B", b, p, d, **kw),
                         block_ops=block_ops)
    dense = p_sim("16B", b, p, d, device="cpu", **kw)
    stream = simulate_serving_stream("16B", b, p, d, device="cpu", **kw)
    assert _same(PCE.cost_many(PAPER, dense, block_ops=block_ops,
                               device="cpu"), want)
    assert _same(PCE.cost_many(PAPER, stream, block_ops=block_ops,
                               device="cpu"), want)


def test_bench_cost_serving_pins():
    """BENCH_cost.json total_cycles_16B: serve_b8_p64_d64 = 22168 and
    serve_b4_p16_d8 = 2596 (the 16B lowering, two KV layers)."""
    for (b, p, d, pl), want in (((8, 64, 64, 8), 22168),
                                ((4, 16, 8, 4), 2596)):
        t = p_sim("16B", b, p, d, page_len=pl, n_kv_layers=2, device="cpu")
        assert PA.get("16B").cost(t, device="cpu").total_cycles == want


def test_negative_raw_bank_folds_like_the_reference():
    """Addresses near 2^31 overflow the int32 xor+add form (``fold`` adds
    a >> log2 B): with a non-pow2 arch in the list the engine takes the
    ``% B`` path, where the fold must keep every bank in [0, B)."""
    a = np.full((4, 16), 2**31 - 1, np.int64) - np.arange(64).reshape(4, 16)
    a = a.astype(np.int32)
    raw = a.astype(np.int64) + (a.astype(np.int64) >> 4)
    assert (raw.astype(np.int32) < 0).any()      # the case exists
    archs = ["16B-fold", "12B", "16B-xor", "6B-offset", "4R-1W-VB"]
    for kind in ("load", "store"):
        want = RCE.cost_many(archs, RTrace.from_ops(a, kind))
        got = PCE.cost_many(archs, PTrace.from_ops(a, kind), device="cpu")
        assert _same(got, want)


def _random_trace(seed, n_ops):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 1 << rng.integers(4, 20), (n_ops, 16))
    mask = rng.random((n_ops, 16)) < rng.uniform(0.3, 1.0)
    kinds = rng.integers(0, 3, n_ops)
    instr = np.cumsum(rng.random(n_ops) < 0.3)
    return addrs.astype(np.int32), mask, kinds.astype(np.int8), instr


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), n_ops=st.integers(1, 96),
       block_ops=st.sampled_from([1, 7, 64, None]))
def test_property_random_traces_equal_reference(seed, n_ops, block_ops):
    addrs, mask, kinds, instr = _random_trace(seed, n_ops)
    want = RCE.cost_many(LATTICE, RTrace(addrs, kinds, instr, mask),
                         block_ops=block_ops)
    got = PCE.cost_many(LATTICE, PTrace(addrs, kinds, instr, mask),
                        block_ops=block_ops, device="cpu")
    assert _same(got, want)


def test_one_shot_stream_raises_on_second_pass():
    blocks = iter([PTrace.from_ops(np.arange(32), "load")])
    s = TraceStream(blocks)
    assert PCE.cost_many(["16B"], s, device="cpu")[0].n_load_ops == 2
    with pytest.raises(RuntimeError):
        PCE.cost_many(["16B"], s, device="cpu")
