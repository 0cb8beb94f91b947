"""The port's complete cost engine held to the JAX reference: ``cost_many``
over the full architecture registry (two-level points included) on the
Table II/III traces, serving traces and random masked traces; the
per-architecture loop ``_cost_loop``; the ``prefetch=`` pipeline over thunk
and generator streams; and ``BlockCostCache`` (warm == cold, the
reference's hit counts, the LRU bound, frozen blocks, tables keyed apart).
Inputs are made from numpy seeds; integers are compared bit for bit."""
import dataclasses
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.bench import fft_workload as r_fft
from repro.bench import transpose_workload as r_transpose
from repro.core import arch as RA
from repro.core import cost_engine as RCE
from repro.core.trace import AddressTrace as RTrace
from repro.core.trace import TraceStream as RStream
from repro.serving.kvcache import simulate_serving_trace as r_sim
from repro_torch.bench.workloads import fft_workload as p_fft
from repro_torch.bench.workloads import transpose_workload as p_transpose
from repro_torch.core import arch as PA
from repro_torch.core import cost_engine as PCE
from repro_torch.core.trace import AddressTrace as PTrace
from repro_torch.core.trace import TraceStream as PStream
from repro_torch.serving.kvcache import simulate_serving_stream
from repro_torch.serving.kvcache import simulate_serving_trace as p_sim

#: the full registry: the nine paper memories and the five extended points
REGISTRY = sorted(RA.names())
EXTENDED = ["12B", "6B-offset", "4x4B-g64", "2x8B-g32", "4x3B"]


def _same(got, want) -> bool:
    """TraceCosts of the two packages (two dataclasses) field for field."""
    return [dataclasses.asdict(c) for c in got] == [
        dataclasses.asdict(c) for c in want]


def _fields(t) -> dict:
    return dict(addrs=t.addrs, kinds=t.kinds, instr=t.instr, mask=t.mask)


def _both(t):
    """A port trace and the reference trace with the same arrays."""
    return t, RTrace(t.addrs, t.kinds, t.instr, t.mask,
                     compute_cycles=t.compute_cycles,
                     op_counts=dict(t.op_counts))


def _rand(rng, n_ops, n_words=512, masked=True):
    addrs = rng.integers(0, n_words, (n_ops, 16)).astype(np.int32)
    kinds = rng.integers(0, 3, n_ops).astype(np.int8)
    instr = np.sort(rng.integers(0, max(1, n_ops // 3), n_ops)).astype(
        np.int32)
    mask = (rng.random((n_ops, 16)) > 0.25) if masked else None
    return PTrace(addrs, kinds, instr, mask)


def test_registry_is_the_references():
    assert sorted(PA.names()) == REGISTRY and len(REGISTRY) == 14


@pytest.mark.parametrize("what", ["t32", "t64", "t128", "fft4", "fft8",
                                  "fft16"])
def test_full_registry_equals_the_reference_on_table_traces(what):
    if what.startswith("t"):
        n = int(what[1:])
        got_t, want_t = p_transpose(n).trace(), r_transpose(n).trace()
    else:
        r = int(what[3:])
        got_t, want_t = p_fft(4096, r).trace(), r_fft(4096, r).trace()
    for k, v in _fields(want_t).items():
        np.testing.assert_array_equal(_fields(got_t)[k], v, err_msg=k)
    got = PCE.cost_many(REGISTRY, got_t, device="cpu")
    assert _same(got, RCE.cost_many(REGISTRY, want_t))
    pins = {"t32": 1613, "t64": 5791, "t128": 26087, "fft4": 64216}
    if what in pins:
        assert got[REGISTRY.index("16B")].total_cycles == pins[what]


@pytest.mark.parametrize("point", [(4, 16, 8, 4), (3, 20, 5, 8),
                                   (8, 64, 64, 8)])
def test_full_registry_equals_the_reference_on_serving_traces(point):
    b, p, d, pl = point
    got_t = p_sim("16B", b, p, d, page_len=pl, n_kv_layers=2, device="cpu")
    want_t = r_sim("16B", b, p, d, page_len=pl, n_kv_layers=2)
    for k, v in _fields(want_t).items():
        np.testing.assert_array_equal(_fields(got_t)[k], v, err_msg=k)
    got = PCE.cost_many(REGISTRY, got_t, device="cpu")
    assert _same(got, RCE.cost_many(REGISTRY, want_t))
    if point == (8, 64, 64, 8):
        assert got[REGISTRY.index("16B")].total_cycles == 22168


@settings(max_examples=15, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), n_ops=st.integers(1, 80),
       block_ops=st.sampled_from([1, 7, 64, None]),
       n_words=st.sampled_from([64, 512, 1 << 20]))
def test_property_random_masked_traces_equal_the_reference(seed, n_ops,
                                                           block_ops,
                                                           n_words):
    p, r = _both(_rand(np.random.default_rng(seed), n_ops, n_words))
    want = RCE.cost_many(REGISTRY, r, block_ops=block_ops)
    got = PCE.cost_many(REGISTRY, p, block_ops=block_ops, device="cpu")
    assert _same(got, want)


@pytest.mark.parametrize("name", REGISTRY)
def test_cost_loop_equals_the_engine_and_the_reference(name):
    rng = np.random.default_rng(11)
    p_arch = PA.get(name)
    for n_ops, masked in ((1, True), (37, True), (96, False)):
        p, r = _both(_rand(rng, n_ops, n_words=1024, masked=masked))
        loop = p_arch._cost_loop(p, device="cpu")
        assert loop == PCE.cost_many([p_arch], p, device="cpu")[0]
        assert _same([loop], [RA.get(name)._cost_loop(r)])


def test_extended_points_batched_streamed_and_chunked_equal():
    rng = np.random.default_rng(14)
    parts = [_rand(rng, n) for n in (5, 1, 33)]
    dense = PTrace.concat(*parts)
    archs = ["16B", "4B-offset", "4R-2W"] + EXTENDED
    want = PCE.cost_many(archs, dense, device="cpu")
    assert PCE.cost_many(archs, dense, block_ops=7, device="cpu") == want
    assert PCE.cost_many(archs, PStream(parts), block_ops=7,
                         device="cpu") == want
    for a, c in zip(archs, want):
        assert c == PA.get(a)._cost_loop(dense, device="cpu"), a


# ------------------------------------------------------------- prefetch --

def _thunk_stream(parts, lat_s=0.0, cls=PStream):
    def mk(p):
        def t():
            if lat_s:
                time.sleep(lat_s)
            return p
        return t
    return cls.from_thunks([mk(p) for p in parts])


def test_from_thunks_equals_the_reference():
    rng = np.random.default_rng(20)
    parts = [_rand(rng, n) for n in (9, 1, 17)]
    s = _thunk_stream(parts)
    assert len(s.thunks) == 3 and PStream(parts).thunks is None
    # a thunk may return an iterable of blocks
    s2 = PStream.from_thunks([lambda: parts[:2], lambda: parts[2]])
    for stream in (s, s2):
        got = [b.addrs for b in stream.blocks(4)]
        want = [b.addrs for b in RStream.from_thunks(
            [lambda p=p: RTrace(p.addrs, p.kinds, p.instr, p.mask)
             for p in parts]).blocks(4)]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(TypeError):
        PStream.from_thunks([parts[0]])


@pytest.mark.parametrize("prefetch", (1, 2, 8))
def test_prefetch_thunk_stream_equals_serial_and_the_reference(prefetch):
    rng = np.random.default_rng(21)
    parts = [_rand(rng, n) for n in (9, 1, 64, 17)]
    archs = ["16B", "8B-offset", "12B", "2x8B-g32"]
    want = PCE.cost_many(archs, PStream(parts), block_ops=16, device="cpu")
    got = PCE.cost_many(archs, _thunk_stream(parts, lat_s=0.002),
                        block_ops=16, prefetch=prefetch, device="cpu")
    assert got == want
    ref = RCE.cost_many(archs, RStream([_both(p)[1] for p in parts]),
                        block_ops=16)
    assert _same(got, ref)


def test_prefetch_generator_stream_equals_serial():
    def stream():
        return simulate_serving_stream("16B", batch=2, prompt_len=9,
                                       decode_steps=4, page_len=8,
                                       device="cpu")
    want = PCE.cost_many(["16B", "4x4B"], stream(), device="cpu")
    got = PCE.cost_many(["16B", "4x4B"], stream(), prefetch=3, device="cpu")
    assert got == want
    assert want[0] == want[1]          # the default granule is flat 16B


def test_prefetch_on_a_dense_trace_is_the_plain_pass():
    t = _rand(np.random.default_rng(22), 40)
    assert (PCE.cost_many(["16B"], t, prefetch=2, device="cpu")
            == PCE.cost_many(["16B"], t, device="cpu"))


def test_prefetch_thunk_exception_propagates():
    def boom():
        raise RuntimeError("constructor died")
    s = PStream.from_thunks(
        [lambda: PTrace.from_stream(np.arange(16), "load"), boom])
    with pytest.raises(RuntimeError, match="constructor died"):
        PCE.cost_many(["16B"], s, prefetch=2, device="cpu")


def test_prefetch_generator_exception_propagates():
    def gen():
        yield PTrace.from_stream(np.arange(16), "load")
        raise RuntimeError("producer died")
    with pytest.raises(RuntimeError, match="producer died"):
        PCE.cost_many(["16B"], PStream(gen), prefetch=2, device="cpu")


@pytest.mark.parametrize("prefetch", (0, -1))
def test_prefetch_below_one_raises(prefetch):
    t = PTrace.from_stream(np.arange(16), "load")
    with pytest.raises(ValueError):
        PCE.cost_many(["16B"], PStream([t]), prefetch=prefetch,
                      device="cpu")


# ---------------------------------------------------------------- cache --

def test_block_digest_equals_the_reference():
    rng = np.random.default_rng(30)
    for masked in (True, False):
        t = _rand(rng, 24, masked=masked)
        got = PCE.BlockCostCache.block_digest(t.addrs, t.mask, t.kinds)
        want = RCE.BlockCostCache.block_digest(t.addrs, t.mask, t.kinds)
        assert got == want
    # an explicit all-True mask digests as no mask
    a, k = t.addrs, t.kinds
    assert (PCE.BlockCostCache.block_digest(a, np.ones_like(a, bool), k)
            == PCE.BlockCostCache.block_digest(a, None, k))


def test_cache_warm_equals_cold_with_the_references_hits():
    rng = np.random.default_rng(31)
    parts = [_rand(rng, 24) for _ in range(6)]
    archs = ["16B", "4B-offset", "12B", "4x4B-g64"]
    stats = []
    for eng, stream, kw in ((PCE, PStream, {"device": "cpu"}),
                            (RCE, RStream, {})):
        ps = parts if eng is PCE else [_both(p)[1] for p in parts]
        cache = eng.BlockCostCache()
        cold = eng.cost_many(archs, stream(ps), cache=cache, **kw)
        after_cold = dict(cache.stats)
        warm = eng.cost_many(archs, stream(ps), cache=cache, **kw)
        assert warm == cold
        assert cold == eng.cost_many(archs, stream(ps), **kw)
        stats.append((after_cold, dict(cache.stats), cold))
    (p_cold_stats, p_stats, p_cold), (r_cold_stats, r_stats, r_cold) = stats
    assert p_cold_stats == r_cold_stats
    assert p_stats == r_stats
    assert p_stats["hits"] == 6 and p_stats["misses"] == 6
    assert _same(p_cold, r_cold)


def test_cache_tables_key_apart():
    """Two arch lists lower to two tables with two digests: a block priced
    under one is a miss under the other, and a hit under its own."""
    t = _rand(np.random.default_rng(32), 32, masked=False)
    a, b = PCE.lower_archs(["16B"]), PCE.lower_archs(["4x4B"])
    assert a.digest != b.digest
    assert a.digest == PCE.lower_archs(["16B"]).digest
    cache = PCE.BlockCostCache()
    c16 = PCE.cost_many(["16B"], t, cache=cache, device="cpu")[0]
    c44 = PCE.cost_many(["4x4B"], t, cache=cache, device="cpu")[0]
    assert cache.stats["hits"] == 0 and cache.stats["misses"] == 2
    assert c16 == PA.get("16B")._cost_loop(t, device="cpu")
    assert c44 == PA.get("4x4B")._cost_loop(t, device="cpu")
    assert PCE.cost_many(["16B"], t, cache=cache, device="cpu")[0] == c16
    assert cache.stats["hits"] == 1


def test_cache_lru_bounded():
    rng = np.random.default_rng(33)
    cache = PCE.BlockCostCache(max_entries=3)
    for _ in range(5):
        PCE.cost_many(["16B"], _rand(rng, 8), cache=cache, device="cpu")
    assert len(cache) == 3 and cache.stats["entries"] == 3
    with pytest.raises(ValueError):
        PCE.BlockCostCache(max_entries=0)


def test_cache_freezes_priced_blocks():
    t = PTrace.from_ops(np.arange(64, dtype=np.int32).reshape(4, 16),
                        kind="load")
    cache = PCE.BlockCostCache()
    want = PCE.cost_many(["16B"], t, cache=cache, device="cpu")
    with pytest.raises(ValueError):
        t.addrs[0, 0] = 99
    t.instr[0] = 0      # instruction ids are not frozen (not keyed)
    # a frozen block still prices, and its digest comes from the memo
    assert PCE.cost_many(["16B"], t, cache=cache, device="cpu") == want
    assert cache.stats["hits"] == 1 and cache.stats["digest_memo"] == 1


def test_cache_folds_misses_every_fold_every_blocks(monkeypatch):
    """Misses stay on the device until folded; folding every 2 misses
    gives the cold pass's integers and stores every block."""
    monkeypatch.setattr(PCE, "_FOLD_EVERY", 2)
    rng = np.random.default_rng(34)
    parts = [_rand(rng, 16) for _ in range(7)]
    archs = ["16B", "4x3B", "4R-1W-VB"]
    cache = PCE.BlockCostCache()
    got = PCE.cost_many(archs, PStream(parts), cache=cache, device="cpu")
    assert got == PCE.cost_many(archs, PStream(parts), device="cpu")
    assert len(cache) == 7
    assert PCE.cost_many(archs, PStream(parts), cache=cache,
                         device="cpu") == got
    assert cache.stats["hits"] == 7


@settings(max_examples=12, deadline=None, database=None)
@given(n_prefix=st.integers(0, 6), seed=st.integers(1, 4),
       block_ops=st.sampled_from([1, 7, 64, 0]))
def test_property_cached_prefix_plus_fresh_suffix(n_prefix, seed, block_ops):
    """Price a prefix of a window through a cache, then the whole window:
    bit-equal to a cold pass and to the reference's."""
    rng = np.random.default_rng(seed)
    parts = [_rand(rng, int(rng.integers(1, 40))) for _ in range(8)]
    bo = sum(p.n_ops for p in parts) if block_ops == 0 else block_ops
    archs = ["16B", "8B-xor", "6B-offset", "2x8B-g32"]
    cache = PCE.BlockCostCache()
    if n_prefix:
        PCE.cost_many(archs, PStream(parts[:n_prefix]), block_ops=bo,
                      cache=cache, device="cpu")
    warm = PCE.cost_many(archs, PStream(parts), block_ops=bo, cache=cache,
                         device="cpu")
    assert warm == PCE.cost_many(archs, PStream(parts), block_ops=bo,
                                 device="cpu")
    ref = RCE.cost_many(archs, RStream([_both(p)[1] for p in parts]),
                        block_ops=bo)
    assert _same(warm, ref)


# ------------------------------------------------------ host bookkeeping --

@settings(max_examples=30, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(0, 200),
       ordered=st.booleans())
def test_dense_ids_equal_np_unique(seed, n, ordered):
    from repro_torch.core.trace import _dense_ids
    rng = np.random.default_rng(seed)
    ids = rng.integers(-5, 40, n).astype(np.int32)
    if ordered:
        ids = np.sort(ids)
    dense, count = _dense_ids(ids)
    u, inv = np.unique(ids, return_inverse=True)
    np.testing.assert_array_equal(dense, inv.reshape(-1))
    assert dense.dtype == np.int32 and count == u.size


@settings(max_examples=30, deadline=None, database=None)
@given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 200),
       ordered=st.booleans())
def test_id_runs_equal_np_unique(seed, n, ordered):
    from repro_torch.core.trace import _id_runs
    rng = np.random.default_rng(seed)
    ids = rng.integers(-5, 40, n).astype(np.int32)
    if ordered:
        ids = np.sort(ids)
    u = np.unique(ids)
    assert _id_runs(ids) == (u.size, int(u[0]), int(u[-1]))


@pytest.mark.parametrize("ordered", [True, False])
def test_instr_counter_equals_the_references(ordered):
    """The per-kind distinct-instruction count over blocks, with ids in
    order (a run count) and out of order (``np.unique``), and kind codes
    outside 0..2 (counted nowhere), as the reference counts them."""
    rng = np.random.default_rng(35 + ordered)
    p, r = PCE._InstrCounter(), RCE._InstrCounter()
    for n_ops in (1, 17, 64, 3, 40):
        ids = rng.integers(0, 12, n_ops)
        if ordered:
            ids = np.sort(ids)
        kinds = rng.choice([0, 1, 2, 2, 5, -1], n_ops).astype(np.int8)
        blk = PTrace(np.zeros((n_ops, 16), np.int32), kinds,
                     ids.astype(np.int32))
        p.add(blk)
        r.add(RTrace(blk.addrs, blk.kinds, blk.instr))
    np.testing.assert_array_equal(p.n_instr, r.n_instr)
    np.testing.assert_array_equal(p.n_ops, r.n_ops)


def test_upload_packs_one_block_and_params_are_uploaded_once():
    import torch
    t = _rand(np.random.default_rng(36), 21)
    addrs, mask, kinds = PCE._upload(t.addrs, t.mask, t.kinds,
                                     torch.device("cpu"))
    np.testing.assert_array_equal(addrs.numpy(), t.addrs)
    np.testing.assert_array_equal(mask.numpy(), t.mask)
    np.testing.assert_array_equal(kinds.numpy(), t.kinds)
    assert addrs.dtype == kinds.dtype == torch.int32
    table = PCE.lower_archs(REGISTRY)
    cpu = torch.device("cpu")
    assert table.params_on(cpu) is table.params_on(cpu)
    np.testing.assert_array_equal(table.params_on(cpu).numpy(),
                                  table.params)

