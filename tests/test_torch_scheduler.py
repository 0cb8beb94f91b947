"""The port's continuous-batching serving (``repro_torch.serving.scheduler``
and ``ServeEngine.run_scheduler``) held to the JAX reference: a counterpart
of every fault-free test of ``tests/test_scheduler.py``, each compared with
the reference's own result on the same inputs (numpy seeds; the model
weights converted with ``from_jax``), plus random serving days event for
event, the live run against the reference's live run, the first ragged
step's logits, the ``serve --schedule`` CLI, the fault paths and
preemption's keywords on the same inputs as the reference
(``tests/test_torch_faults.py`` holds the fault paths in full), and a
chunked day preempted mid-prefill and resumed.

Integers (page ids, traces, cycles, ticks, tokens) are compared exactly;
``stats()`` floats too (the same float32 arithmetic on the same small
integer vectors).  Logits agree to atol 1e-4 (float32 compute; the
reduction orders of XLA:CPU and torch differ, see
``tests/test_torch_serving.py``)."""
import argparse
import dataclasses
import json
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import tune as RTune
from repro.analysis import validate as r_validate
from repro.bench import scheduler_workload as r_sched_wl
from repro.bench import serving_workload as r_serve_wl
from repro.bench import sweep as r_sweep
from repro.configs import get_smoke_config as r_smoke
from repro.configs.base import RunConfig as RRun
from repro.core import arch as RA
from repro.core.cost_engine import cost_many as r_cost_many
from repro.core.trace import AddressTrace as RTrace
from repro.launch import serve as r_serve_cli
from repro.launch.sharding import NO_AXES
from repro.models import init_tree as r_init
from repro.models import model_specs as r_specs
from repro.serving import kvcache as RKV
from repro.serving import scheduler as RS
from repro.serving.engine import ServeEngine as RServe
from repro_torch import tune as PTune
from repro_torch.analysis import validate as p_validate
from repro_torch.bench import scheduler_workload as p_sched_wl
from repro_torch.bench import serving_workload as p_serve_wl
from repro_torch.bench import sweep as p_sweep
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import RunConfig
from repro_torch.core import arch as PA
from repro_torch.core.cost_engine import cost_many as p_cost_many
from repro_torch.core.trace import AddressTrace as PTrace
from repro_torch.launch import serve as p_serve_cli
from repro_torch.launch.sharding import NO_AXES as P_NO_AXES
from repro_torch.models import from_jax, model_specs
from repro_torch.serving import kvcache as PKV
from repro_torch.serving import scheduler as PS
from repro_torch.serving.engine import SchedulerRunResult, ServeEngine

CFG = get_smoke_config("llama3.2-1b")
RCFG = r_smoke("llama3.2-1b")
R_PARAMS = r_init(r_specs(RCFG), jax.random.PRNGKey(0))
PARAMS = from_jax(model_specs(CFG), jax.tree.map(np.asarray, R_PARAMS),
                  device="cpu")
P_RC = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
R_RC = RRun(remat="none", attn_impl="dense", compute_dtype="float32")

#: the pinned small live-vs-sim traffic of the reference's tests:
#: staggered arrivals, a page-boundary prompt, a zero-new-token request,
#: more requests than lanes — (arrival, prompt_len, max_new)
TRAFFIC = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0), (2, 9, 5),
           (3, 12, 3))
FIELDS = ("addrs", "kinds", "instr", "mask")


def _requests(mod, spec=TRAFFIC, seed=0, tokens=True):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, arrival=a, prompt_len=p, max_new_tokens=m,
                        tokens=(rng.integers(0, CFG.vocab_size, p)
                                .astype(np.int32) if tokens else None))
            for i, (a, p, m) in enumerate(spec)]


def _both(spec=TRAFFIC, seed=0, tokens=True):
    return (_requests(PS, spec, seed, tokens),
            _requests(RS, spec, seed, tokens))


def _sched(mod, n_lanes=4, max_seq=32, policy="seq-skew", arch="16B",
           **kw):
    cfg = mod.scheduler_pool_config(arch, n_lanes, max_seq, page_len=8)
    return mod.Scheduler(cfg, n_lanes=n_lanes, max_seq=max_seq,
                         policy=policy, **kw)


def _engine(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 32)
    kw.setdefault("page_len", 8)
    return ServeEngine(CFG, P_RC, PARAMS, P_NO_AXES,
                       kv_mode="paged", device="cpu",
                       **kw)


@pytest.fixture(scope="module")
def r_engine():
    """One reference engine for the module: its jitted prefill and ragged
    step compile once per prompt length, not once per test."""
    return RServe(RCFG, R_RC, R_PARAMS, NO_AXES, kv_mode="paged",
                  max_batch=4, max_seq=32, page_len=8)


def _traces_equal(got, want) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def _event(ev) -> dict:
    """A TickEvent as plain data (rids for requests, lists for arrays)."""
    def arr(a):
        return None if a is None else np.asarray(a).tolist()
    return {
        "tick": ev.tick, "decoded": ev.decoded,
        "admitted": [(a.request.rid, a.lane, arr(a.page_ids))
                     for a in ev.admitted],
        "completed": [(c.request.rid, c.lane, c.tick, c.cancelled)
                      for c in ev.completed],
        "prefill_chunks": [{**c, "page_ids": arr(c["page_ids"])}
                           for c in ev.prefill_chunks],
        "page_table": arr(ev.page_table), "pos": arr(ev.pos),
        "active": arr(ev.active),
        "traces": [(t.meta, t.addrs.tolist(), t.kinds.tolist(),
                    t.instr.tolist(), arr(t.mask)) for t in ev.traces],
        "faults": (ev.migrations, [_record(r) for r in ev.recoveries],
                   ev.transients, ev.preempt)}


def _record(rec: dict) -> dict:
    """A recovery record as plain data (the request as its rid, arrays as
    lists)."""
    return {k: (v.rid if k == "request" else
                np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in rec.items()}


def _run_events(s, reqs=None):
    return [_event(e) for e in s.run(reqs)]


# -- page pool ---------------------------------------------------------------

def test_pool_alloc_free_roundtrip_and_determinism():
    ids = {}
    for mod in (PS, RS):
        cfg = mod.scheduler_pool_config("16B", 4, 64, 8)
        p1, p2 = (mod.PagePool(cfg, policy="seq-skew") for _ in range(2))
        ids1 = [p1.alloc(k, 3) for k in range(8)]
        assert ids1 == [p2.alloc(k, 3) for k in range(8)]
        assert len(set(ids1)) == 8
        p1.release(ids1)
        assert p1.n_free == cfg.n_pages
        with pytest.raises(ValueError):
            p1.release([ids1[0]])                # double free
        ids[mod] = ids1
    assert ids[PS] == ids[RS]
    lay = PS.scheduler_pool_config("16B", 4, 64, 8).layout
    banks = [int(b) for b in lay.bank_slot(np.array(ids[PS]))[0]]
    skew = PKV.ALLOC_POLICIES["seq-skew"]
    assert banks == [skew(int(lay.bank_slot(np.array(k))[0]), 3, 16)
                     for k in range(8)]


def test_pool_spills_to_least_loaded_and_exhausts():
    got = {}
    for mod in (PS, RS):
        cfg = mod.scheduler_pool_config("16B", 2, 16, 8)   # tiny pool
        pool = mod.PagePool(cfg, policy="paper")
        ids = [pool.alloc(0, 0) for _ in range(cfg.n_pages)]
        assert len(set(ids)) == cfg.n_pages and pool.n_free == 0
        with pytest.raises(RuntimeError):
            pool.alloc(0, 0)
        assert int(pool.bank_used.max()) - int(pool.bank_used.min()) <= 1
        got[mod] = (ids, pool.bank_used.tolist(), pool.state_dict())
    assert got[PS] == got[RS]


@pytest.mark.parametrize("used", [[4, 2, 0, 6], [3, 3, 3, 3],
                                  list(range(16)), [0] * 15 + [7]])
def test_bank_load_stats_reports_skew(used):
    got = {k: float(v) for k, v in PKV.bank_load_stats(
        np.array(used)).items()}
    want = {k: float(v) for k, v in RKV.bank_load_stats(
        np.array(used)).items()}
    assert got == want
    if used == [4, 2, 0, 6]:
        assert (got["max"], got["min"], got["mad"],
                got["max_min_ratio"]) == (6, 0, 2.0, 6.0)


# -- lane lifecycle ----------------------------------------------------------

def test_all_lanes_busy_queues_fcfs():
    """6 requests on 4 lanes: the last two wait and enter freed lanes in
    FCFS order; every event is the reference's."""
    p_reqs, r_reqs = _both(tokens=False)
    s = _sched(PS)
    got = _run_events(s, p_reqs)
    assert got == _run_events(_sched(RS), r_reqs)
    adm = [a for e in got for a in e["admitted"]]
    assert [r for r, _, _ in adm[:4]] == [0, 1, 2, 3]
    comp = [c[0] for e in got for c in e["completed"]]
    assert sorted(comp) == [0, 1, 2, 3, 4, 5] and comp != sorted(comp)
    assert s.pool.n_free == s.pool.free.size - 1        # scratch reserved


def test_zero_new_token_request_releases_lane_without_decoding():
    got = _run_events(_sched(PS), [PS.Request(0, 0, 3, 0)])
    assert got == _run_events(_sched(RS), [RS.Request(0, 0, 3, 0)])
    assert not any(e["decoded"] for e in got)
    assert sum(len(e["traces"]) for e in got) == 1      # prefill only


def test_cancel_mid_flight_frees_lane_for_readmission():
    """Evict a long request mid-generation; the queued request takes the
    same lane the same tick, as in the reference."""
    out = {}
    for mod in (PS, RS):
        s = _sched(mod, n_lanes=1, max_seq=32)
        s.submit([mod.Request(0, 0, 8, 20), mod.Request(1, 0, 8, 2)])
        evs = [_event(s.tick()), _event(s.tick())]
        s.cancel(0)
        ev = s.tick()
        assert [(c.request.rid, c.cancelled) for c in ev.completed] == [
            (0, True)]
        assert [(a.request.rid, a.lane) for a in ev.admitted] == [(1, 0)]
        evs += [_event(ev)] + _run_events(s)
        assert s.pool.n_free == s.pool.free.size - 1
        out[mod] = (evs, s.stats(), s.state_dict())
    assert out[PS] == out[RS]


def test_cancel_queued_request_never_admits():
    out = {}
    for mod in (PS, RS):
        s = _sched(mod, n_lanes=1)
        s.submit(_requests(mod, ((0, 4, 2), (0, 4, 2)), tokens=False))
        s.cancel(1)
        out[mod] = _run_events(s)
        assert {a[0] for e in out[mod] for a in e["admitted"]} == {0}
        with pytest.raises(KeyError):
            s.cancel(7)
    assert out[PS] == out[RS]


def test_requests_validate_and_reject_bad_budgets():
    for mod in (PS, RS):
        with pytest.raises(ValueError):
            mod.Request(0, 0, prompt_len=0, max_new_tokens=1)
        with pytest.raises(ValueError):
            mod.Request(0, 0, prompt_len=4, max_new_tokens=-1)
        s = _sched(mod, max_seq=16)
        with pytest.raises(ValueError):
            s.submit([mod.Request(0, 0, prompt_len=10, max_new_tokens=10)])
        s.submit([mod.Request(1, 0, prompt_len=4, max_new_tokens=2)])
        with pytest.raises(ValueError):
            s.submit([mod.Request(1, 0, prompt_len=4, max_new_tokens=2)])


# -- trace contract ----------------------------------------------------------

def _report(rep) -> dict:
    return dataclasses.asdict(rep)


def test_scheduler_stream_validates_and_reiterates():
    """Every scheduler stream passes the trace contract twice (each pass
    replays a fresh scheduler) with the reference's report, and
    materializes to the reference's trace."""
    p_reqs, r_reqs = _both(tokens=False)
    for arch in ("16B", "16B-xor", "4R-2W"):
        kw = dict(n_lanes=4, max_seq=32, n_kv_layers=2)
        got = PS.simulate_scheduler_stream(arch, p_reqs, **kw)
        want = RS.simulate_scheduler_stream(arch, r_reqs, **kw)
        rep1 = p_validate(got, arch=arch, block_ops=64)
        rep2 = p_validate(got, arch=arch, block_ops=64)
        assert rep1.ok and rep1.n_ops > 0
        assert _report(rep1) == _report(rep2) == _report(
            r_validate(want, arch=arch, block_ops=64))
        t1, t2 = got.materialize(), got.materialize()
        _traces_equal(t1, t2)
        _traces_equal(t1, want.materialize())
        assert got.meta == want.meta


def test_policy_changes_placement_not_contract():
    """seq-skew spreads same-index pages of different tenants across banks;
    both policies validate, and the costs are the reference's (seq-skew's
    concurrent prefill writes cost fewer store cycles)."""
    spec = tuple((0, 8, 2) for _ in range(8))
    p_reqs, r_reqs = _both(spec, tokens=False)
    costs = {}
    for policy in ("paper", "seq-skew"):
        kw = dict(n_lanes=8, max_seq=32, policy=policy)
        got = PS.simulate_scheduler_stream("16B", p_reqs, **kw)
        assert p_validate(got, arch="16B", block_ops=64).ok
        costs[policy] = p_cost_many([PA.get("16B")], got, device="cpu")[0]
        want = r_cost_many([RA.get("16B")], RS.simulate_scheduler_stream(
            "16B", r_reqs, **kw))[0]
        assert dataclasses.asdict(costs[policy]) == dataclasses.asdict(want)
    assert costs["seq-skew"].store_cycles < costs["paper"].store_cycles
    assert costs["seq-skew"].n_store_ops == costs["paper"].n_store_ops


def test_seq_skew_flattens_bank_occupancy():
    spec = tuple((0, 8, 2) for _ in range(16))
    for policy in ("paper", "seq-skew"):
        got = {}
        for mod, kv in ((PS, PKV), (RS, RKV)):
            s = _sched(mod, n_lanes=16, max_seq=32, policy=policy)
            s.submit(_requests(mod, spec, tokens=False))
            s.tick()
            got[mod] = {k: float(v)
                        for k, v in kv.bank_load_stats(s.pool).items()}
        assert got[PS] == got[RS]
        if policy == "seq-skew":
            assert got[PS]["mad"] < 0.2


# -- random serving days, event for event -------------------------------------

ARCHS = ("16B", "16B-xor", "4R-2W", "8B")


@pytest.mark.parametrize("seed", range(12))
def test_random_days_equal_the_reference_event_for_event(seed):
    """Seeded days over the context distributions, 1-16 lanes, four
    memories, both policies and chunks of 1-4 pages (or none): every
    TickEvent, the stream, ``stats()`` and ``state_dict()`` are the
    reference's, bit for bit."""
    rng = np.random.default_rng(100 + seed)
    dist = ("short", "long", "mixed")[seed % 3]
    n_lanes = int(rng.integers(1, 17))
    arch = ARCHS[seed % 4]
    policy = ("paper", "seq-skew")[seed % 2]
    chunk = (None, 1, 2, 3, 4)[seed % 5]
    max_seq = int(rng.choice([32, 64, 128]))
    n_req = int(rng.integers(4, 40))
    rate = float(rng.choice([0.3, 1.0, 2.5]))
    day = {mod: mod.synthesize_requests(n_req, rate, dist, max_seq=max_seq,
                                        seed=seed)
           for mod in (PS, RS)}
    out = {}
    for mod in (PS, RS):
        s = _sched(mod, n_lanes=n_lanes, max_seq=max_seq, policy=policy,
                   arch=arch, n_kv_layers=2, prefill_chunk_pages=chunk)
        out[mod] = (_run_events(s, day[mod]), s.stats(), s.state_dict())
    assert out[PS] == out[RS]
    kw = dict(n_lanes=n_lanes, max_seq=max_seq, n_kv_layers=2,
              policy=policy, prefill_chunk_pages=chunk)
    got = PS.simulate_scheduler_stream(arch, day[PS], **kw)
    want = RS.simulate_scheduler_stream(arch, day[RS], **kw)
    _traces_equal(got.materialize(), want.materialize())
    assert got.meta == want.meta


# -- live engine -------------------------------------------------------------

def test_run_scheduler_matches_generate_greedy(r_engine):
    """A one-request day reduces to fixed-batch greedy decode: the port's
    tokens equal its own ``generate`` and the reference's run."""
    eng = _engine()
    p_reqs, r_reqs = _both(((0, 12, 8),))
    out = eng.run_scheduler(p_reqs).outputs[0]
    want = eng.generate(p_reqs[0].tokens[None, :],
                        max_new_tokens=8).tokens[0]
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, r_engine.run_scheduler(
        r_reqs).outputs[0])


def test_run_scheduler_lanes_are_independent(r_engine):
    """A request decodes the same tokens alone and co-scheduled, as in the
    reference."""
    eng = _engine()
    spec = ((0, 12, 6), (0, 8, 4), (1, 5, 5))
    p_reqs, r_reqs = _both(spec)
    alone = eng.run_scheduler([p_reqs[0]]).outputs[0]
    together = eng.run_scheduler(p_reqs).outputs
    np.testing.assert_array_equal(together[0], alone)
    want = r_engine.run_scheduler(r_reqs).outputs
    for r in p_reqs:
        assert len(together[r.rid]) == r.max_new_tokens
        np.testing.assert_array_equal(together[r.rid], want[r.rid])


@pytest.mark.parametrize("chunk", [None, 1])
def test_live_run_equals_the_reference_and_the_simulation(r_engine, chunk):
    """The acceptance pins: the port's live run gives the reference's
    tokens, ``stats()``, ticks and live trace, bit-equal to the model-free
    simulation; unchunked, 80 ops, 2800 cycles on 16B, 128 on 4R-2W and 8
    ticks."""
    eng = _engine()
    p_reqs, r_reqs = _both()
    res = eng.run_scheduler(p_reqs, policy="seq-skew",
                            prefill_chunk_pages=chunk)
    want = r_engine.run_scheduler(r_reqs, policy="seq-skew",
                                  prefill_chunk_pages=chunk)
    assert isinstance(res, SchedulerRunResult)
    assert sorted(res.outputs) == sorted(want.outputs)
    for r in p_reqs:
        assert len(res.outputs[r.rid]) == r.max_new_tokens
        np.testing.assert_array_equal(res.outputs[r.rid],
                                      want.outputs[r.rid])
    assert (res.stats, res.ticks, res.preempted, res.checkpoint) == (
        want.stats, want.ticks, want.preempted, want.checkpoint)
    live = eng.scheduler_stream().materialize()
    sim = PS.simulate_scheduler_stream(
        eng.mem_arch, p_reqs, n_lanes=4, max_seq=32, page_len=8,
        n_kv_layers=eng.n_kv_layers, policy="seq-skew",
        prefill_chunk_pages=chunk).materialize()
    _traces_equal(live, sim)
    _traces_equal(live, r_engine.scheduler_stream().materialize())
    assert eng.scheduler_stream().meta == r_engine.scheduler_stream().meta
    archs = [a.name for a in PA.PAPER_ARCHITECTURES]
    assert [c.total_cycles for c in eng.scheduler_cost(archs)] == [
        c.total_cycles for c in r_engine.scheduler_cost(archs)]
    if chunk is None:
        assert live.n_ops == 80 and res.ticks == 8
        assert PA.get("16B").cost(live, device="cpu").total_cycles == 2800
        assert eng.scheduler_cost().total_cycles == 2800
        assert PA.get("4R-2W").cost(live, device="cpu").total_cycles == 128
    else:
        assert res.ticks > 8                  # 1-page chunks stretch the day


def test_first_ragged_step_logits_match_the_reference(r_engine):
    """Three requests admitted at once, then one lane-ragged step at three
    different positions with one idle lane: the port's logits within atol
    1e-4 of the reference's, the pools' page lines too."""
    p_reqs, r_reqs = _both(((0, 12, 4), (0, 5, 4), (0, 9, 4)))
    eng = _engine()
    sched = _sched(PS)
    sched.submit(p_reqs)
    ev = sched.tick()
    assert ev.decoded and len(ev.admitted) == 3
    dtype = jnp.float32
    kv = eng.kv_cfg
    r_pools = {f"b0s{sb}": {h: jnp.zeros((kv.n_pages, kv.row_width), dtype)
                            for h in ("k", "v")}
               for sb in range(CFG.n_superblocks)}
    p_pools = {f"b0s{sb}": {h: torch.zeros((kv.n_pages, kv.row_width))
                            for h in ("k", "v")}
               for sb in range(CFG.n_superblocks)}
    toks = np.zeros(4, np.int64)
    with torch.inference_mode():
        for adm, p_req, r_req in zip(ev.admitted, p_reqs, r_reqs):
            p_pools, first = eng._ingest_request(p_pools, p_req.tokens,
                                                 adm.page_ids)
            r_pools, r_first = r_engine._ingest_request(
                r_pools, r_req.tokens, adm.page_ids)
            assert first == r_first
            toks[adm.lane] = first
        scratch = sched.scratch_page
        pl, p_pools = eng._scheduler_step(PARAMS, toks, p_pools,
                                          ev.page_table, ev.pos, ev.active,
                                          scratch)
    rl, r_pools = r_engine._decode_sched(
        r_engine.params, jnp.asarray(toks, jnp.int32)[:, None], r_pools,
        jnp.asarray(ev.page_table), jnp.asarray(ev.pos),
        jnp.asarray(ev.active), jnp.asarray(scratch, jnp.int32))
    act = ev.active
    np.testing.assert_allclose(pl.numpy()[act], np.asarray(rl)[act],
                               atol=1e-4, rtol=0)
    for key in p_pools:
        for h in ("k", "v"):
            got, want = p_pools[key][h].numpy(), np.asarray(r_pools[key][h])
            live = np.ones(kv.n_pages, bool)
            live[PA.get("16B").layout.physical_row(scratch, kv.n_pages)] = 0
            np.testing.assert_allclose(got[live], want[live], atol=1e-5,
                                       rtol=0)


def test_run_scheduler_rejects_dense_and_requests_without_tokens(r_engine):
    dense = ServeEngine(CFG, P_RC, PARAMS, P_NO_AXES, max_batch=4, max_seq=32,
                        kv_mode="dense", device="cpu")
    r_dense = RServe(RCFG, R_RC, R_PARAMS, NO_AXES, max_batch=4, max_seq=32,
                     kv_mode="dense")
    p_reqs, r_reqs = _both()
    for eng, reqs in ((dense, p_reqs), (r_dense, r_reqs)):
        with pytest.raises(ValueError):
            eng.run_scheduler(reqs)
    p_bare, r_bare = _both(((0, 4, 2),), tokens=False)
    for eng, reqs in ((_engine(), p_bare), (r_engine, r_bare)):
        with pytest.raises(ValueError):      # tokens required on live path
            eng.run_scheduler(reqs)


def test_run_scheduler_refuses_non_attention_models():
    hybrid = _engine()
    hybrid.cfg = _Hybrid(CFG)
    with pytest.raises(NotImplementedError, match="attention-only"):
        hybrid.run_scheduler(_requests(PS))


class _Hybrid:
    """A config whose pattern holds an SSM block (the port has no hybrid
    config yet): the live path refuses it as the reference does."""

    def __init__(self, cfg):
        self._cfg = cfg

    def __getattr__(self, name):
        return getattr(self._cfg, name)

    def block_pattern(self):
        return (("attn", False), ("ssm", False))


# -- the serving day through the streaming protocol --------------------------

def test_thousand_sequence_day_costs_in_block_memory():
    """A 1000-sequence mixed day priced through the streaming protocol in
    host memory well under the dense (ops × 16) matrix, at the
    reference's cost."""
    kw = dict(n_requests=1000, arrival_rate=2.0, context_dist="mixed",
              n_lanes=16, max_seq=128, n_kv_layers=2, seed=0)
    wl = p_sched_wl(**kw)
    a16 = PA.get("16B")
    stream = wl.stream_fn(a16)
    n_ops = sum(b.n_ops for b in stream.blocks(block_ops=2048))
    assert n_ops > 30_000
    p_cost_many([a16], stream, block_ops=2048, device="cpu")
    tracemalloc.start()
    try:
        cost = p_cost_many([a16], stream, block_ops=2048, device="cpu")[0]
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < n_ops * 16 * 4
    want = r_cost_many([RA.get("16B")], r_sched_wl(**kw).stream_fn(
        RA.get("16B")), block_ops=2048)[0]
    assert dataclasses.asdict(cost) == dataclasses.asdict(want)
    assert wl.meta == r_sched_wl(**kw).meta


def test_scheduler_workload_sweeps_and_reports_tokens():
    kw = dict(n_requests=16, arrival_rate=1.0, context_dist="short",
              n_lanes=4, max_seq=64, seed=0)
    wl = p_sched_wl(**kw)
    recs = p_sweep(["16B", "4R-2W"], [wl], device="cpu")
    assert len(recs) == 2
    assert all(r["n_tokens"] == wl.meta["n_tokens"] > 0 for r in recs)
    assert all(r["total_cycles"] > 0 for r in recs)
    assert recs == list(r_sweep(["16B", "4R-2W"], [r_sched_wl(**kw)]))
    assert wl.name == r_sched_wl(**kw).name


def test_synthesize_requests_deterministic_and_bounded():
    a = PS.synthesize_requests(50, 2.0, "mixed", max_seq=64, seed=3,
                               vocab_size=CFG.vocab_size)
    b = RS.synthesize_requests(50, 2.0, "mixed", max_seq=64, seed=3,
                               vocab_size=CFG.vocab_size)
    assert [(r.rid, r.arrival, r.prompt_len, r.max_new_tokens,
             r.tokens.tolist()) for r in a] == [
        (r.rid, r.arrival, r.prompt_len, r.max_new_tokens,
         r.tokens.tolist()) for r in b]
    assert all(r.total_len <= 64 for r in a)
    assert PS.total_new_tokens(a) == RS.total_new_tokens(b) > 0
    arrivals = [r.arrival for r in a]
    assert arrivals == sorted(arrivals)
    assert set(PS.CONTEXT_DISTS) == set(RS.CONTEXT_DISTS)
    for mod in (PS, RS):
        with pytest.raises(ValueError):
            mod.synthesize_requests(4, 1.0, "nope")
        with pytest.raises(ValueError):
            mod.synthesize_requests(4, 0.0, "short")


# -- tune: the multi-tenant ranking flip -------------------------------------

def _ranking(results):
    return [(r.arch, r.total_cycles, r.objective) for r in results]


def test_tune_ranking_flips_under_multitenant_load():
    """The fixed-batch serving winner (4R-2W) loses a low-arrival-rate
    continuous-batching day to 4R-1W under ``us_per_token``; both
    rankings are the reference's, point for point."""
    serve = dict(batch=4, prompt_len=16, decode_steps=8, page_len=4,
                 n_kv_layers=2)
    fixed = PTune.search(workload=p_serve_wl(**serve, device="cpu"),
                         device="cpu")
    assert fixed[0].arch == "4R-2W"
    day_kw = dict(n_requests=48, arrival_rate=0.5, context_dist="long",
                  n_lanes=8, max_seq=128, n_kv_layers=2, seed=0)
    day = PTune.search(workload=p_sched_wl(**day_kw),
                       objective="us_per_token", device="cpu")
    assert day[0].arch == "4R-1W"
    assert day[0].objective < day[1].objective
    assert {r.arch for r in day} == {r.arch for r in fixed}
    assert _ranking(day) == _ranking(RTune.search(
        workload=r_sched_wl(**day_kw), objective="us_per_token"))
    assert _ranking(fixed) == _ranking(RTune.search(
        workload=r_serve_wl(**serve)))


def test_us_per_token_objective_needs_token_meta():
    with pytest.raises(ValueError):
        PTune.search(workload=p_serve_wl(batch=2, prompt_len=8,
                                         decode_steps=4, page_len=4,
                                         device="cpu"),
                     objective="us_per_token", device="cpu")


# -- chunked prefill ---------------------------------------------------------

def _run_all(s):
    evs = []
    while not s.done():
        evs.append(s.tick())
    return evs


def _concat(events, trace_cls):
    return trace_cls.concat(*[t for e in events for t in e.traces])


def test_chunked_prefill_covering_chunk_reproduces_legacy():
    """A chunk covering every prompt degenerates to whole-prompt admission:
    the same events and trace bytes, one done=True chunk per admission,
    and the reference's chunked events."""
    out = {}
    for mod, tcls in ((PS, PTrace), (RS, RTrace)):
        legacy, chunked = _sched(mod), _sched(mod, prefill_chunk_pages=8)
        legacy.submit(_requests(mod, tokens=False))
        chunked.submit(_requests(mod, tokens=False))
        e1, e2 = _run_all(legacy), _run_all(chunked)
        assert len(e1) == len(e2)
        for a, b in zip(e1, e2):
            assert ([(x.request.rid, x.lane, x.page_ids.tolist())
                     for x in a.admitted]
                    == [(x.request.rid, x.lane, x.page_ids.tolist())
                        for x in b.admitted])
        t1, t2 = _concat(e1, tcls), _concat(e2, tcls)
        for f in ("addrs", "kinds", "instr"):
            np.testing.assert_array_equal(getattr(t1, f), getattr(t2, f))
        chunks = [c for e in e2 for c in e.prefill_chunks]
        assert len(chunks) == len(TRAFFIC) and all(c["done"] for c in chunks)
        out[mod] = [_event(e) for e in e2]
    assert out[PS] == out[RS]


def test_chunked_prefill_interleaves_pages_with_decode():
    """Chunks of one page: multi-page prompts prefill over several ticks,
    tile their pages in order, and every request still completes; the
    events are the reference's."""
    out = {}
    for mod in (PS, RS):
        s = _sched(mod, prefill_chunk_pages=1)
        reqs = _requests(mod, tokens=False)
        s.submit(reqs)
        events = _run_all(s)
        chunks = [c for e in events for c in e.prefill_chunks]
        for r in reqs:
            mine = [c for c in chunks if c["rid"] == r.rid]
            n_pages = -(-r.prompt_len // 8)
            assert [c["page_start"] for c in mine] == list(range(n_pages))
            assert [c["done"] for c in mine] == [False] * (n_pages - 1) + [
                True]
            ticks = [e.tick for e in events for c in e.prefill_chunks
                     if c["rid"] == r.rid]
            assert ticks == sorted(ticks) and len(set(ticks)) == len(ticks)
        done = {c.request.rid for e in events for c in e.completed
                if not c.cancelled}
        assert done == {r.rid for r in reqs}
        assert s.stats()["prefill_chunks"] == len(chunks)
        out[mod] = ([_event(e) for e in events], s.stats())
    assert out[PS] == out[RS]


def test_chunked_prefill_stream_validates_and_prices():
    """The chunked stream passes the contract with the reference's report,
    prices at the reference's cost, and writes the same prefill page words
    as whole-prompt admission."""
    kw = dict(n_lanes=4, max_seq=32, page_len=8)
    p_reqs, r_reqs = _both(tokens=False)
    got = PS.simulate_scheduler_stream("16B", p_reqs, prefill_chunk_pages=1,
                                       **kw)
    want = RS.simulate_scheduler_stream("16B", r_reqs,
                                        prefill_chunk_pages=1, **kw)
    assert _report(p_validate(got, PA.get("16B"))) == _report(
        r_validate(want, RA.get("16B")))

    def prefill_words(cp):
        s = PS.simulate_scheduler_stream("16B", p_reqs,
                                         prefill_chunk_pages=cp, **kw)
        out = []
        for b in s:
            if str(b.meta.get("what", "")).startswith("sched_prefill"):
                m = (np.ones_like(b.addrs, bool) if b.mask is None
                     else np.asarray(b.mask))
                out.append(b.addrs[m])
        return np.sort(np.concatenate(out))

    np.testing.assert_array_equal(prefill_words(1), prefill_words(None))
    assert dataclasses.asdict(p_cost_many(
        [PA.get("16B")], got.materialize(), device="cpu")[0]) == (
        dataclasses.asdict(r_cost_many([RA.get("16B")],
                                       want.materialize())[0]))


def test_chunked_prefill_state_dict_mid_prefill_resumes_identically():
    """``state_dict`` taken while a lane is mid-prefill is the reference's
    JSON, and restores (into either package's scheduler) to the same
    remaining schedule."""
    sds = {}
    for mod in (PS, RS):
        s1 = _sched(mod, prefill_chunk_pages=1)
        s1.submit(_requests(mod))
        s1.tick()
        sds[mod] = s1.state_dict()
    assert json.dumps(sds[PS]) == json.dumps(sds[RS])
    sd = json.loads(json.dumps(sds[PS]))
    assert sd["prefill_next"] and sd == sds[PS]
    tails = []
    for mod in (PS, RS):
        s2 = _sched(mod, prefill_chunk_pages=1)
        s2.load_state(json.loads(json.dumps(sd)))
        assert s2.state_dict() == sd
        tails.append(([_event(e) for e in _run_all(s2)], s2.stats()))
    assert tails[0] == tails[1]


def test_chunked_prefill_validation():
    for mod in (PS, RS):
        with pytest.raises(ValueError):
            _sched(mod, prefill_chunk_pages=0)


# -- the serve CLI ----------------------------------------------------------

def test_serve_schedule_cli_prints_the_references_lines(capsys):
    """``serve --schedule --smoke --cost``'s ``run_schedule`` on the same
    smoke config and weights: every request's tokens, the stats line and
    the cost table are the reference CLI's, line for line."""
    args = argparse.Namespace(
        n_requests=8, arrival_rate=1.5, context_dist="mixed", seed=0,
        policy="seq-skew", cost=True, fault_bank=None, fault_tick=4)
    max_seq = 16 + 32 + 4                 # the CLIs' prompt + new + 4
    eng = ServeEngine(CFG, RunConfig(remat="none", attn_impl="dense"),
                      PARAMS, P_NO_AXES,
                      max_batch=4, max_seq=max_seq, device="cpu")
    p_serve_cli.run_schedule(args, eng, CFG)
    got = capsys.readouterr().out
    r_eng = RServe(RCFG, RRun(remat="none", attn_impl="dense"), R_PARAMS,
                   NO_AXES, max_batch=4, max_seq=max_seq)
    r_serve_cli.run_schedule(args, r_eng, RCFG)
    want = capsys.readouterr().out
    assert got == want
    lines = got.splitlines()
    assert sum(ln.startswith("req") for ln in lines) == 8
    assert any("decode steps, lane occupancy" in ln for ln in lines)
    assert [ln.split()[0] for ln in lines[-6:]] == list(
        p_serve_cli.COST_MEMORIES)


# -- the fault paths and preemption -----------------------------------------

def test_fault_paths_raise_not_implemented_naming_slice_4b(r_engine,
                                                           tmp_path):
    """Each fault path this test once held refused now runs and equals the
    reference on the same inputs (the full chaos suite is
    ``tests/test_torch_faults.py``), preemption's keywords (``guard=``,
    ``checkpoint_dir=``, ``resume_from=``) too, and the refusals left are
    the reference's ``ValueError``s.  (The test keeps its name from when
    the whole fault slice was refused.)"""
    from repro.runtime import FaultEvent as RFE
    from repro.runtime import FaultPlan as RFP
    from repro.runtime import StepWatchdog as RWD
    from repro_torch.runtime import FaultEvent, FaultPlan, StepWatchdog

    def plan(mod_plan, mod_event):
        return mod_plan((mod_event(tick=1, kind="bank_offline", bank=2),
                         mod_event(tick=2, kind="page_corrupt", rid=0),
                         mod_event(tick=3, kind="decode_transient",
                                   failures=2)))

    p_plan, r_plan = plan(FaultPlan, FaultEvent), plan(RFP, RFE)
    p_reqs, r_reqs = _both(tokens=False)
    got = _sched(PS, fault_plan=p_plan, watchdog=StepWatchdog())
    want = _sched(RS, fault_plan=r_plan, watchdog=RWD())
    assert _run_events(got, p_reqs) == _run_events(want, r_reqs)
    assert set(got.stats()) == set(want.stats())
    assert got.stats()["faults"] == want.stats()["faults"]
    assert got.stats()["faults"]["dead_banks"] == [2]
    p_stream = PS.simulate_scheduler_stream("16B", p_reqs, n_lanes=4,
                                            max_seq=32, fault_plan=p_plan)
    r_stream = RS.simulate_scheduler_stream("16B", r_reqs, n_lanes=4,
                                            max_seq=32, fault_plan=r_plan)
    assert p_stream.meta == r_stream.meta
    _traces_equal(p_stream.materialize(), r_stream.materialize())
    cfgs = [mod.scheduler_pool_config("16B", 4, 32, 8) for mod in (PS, RS)]
    _traces_equal(PS.fault_migrate_trace(cfgs[0], [1], [2]),
                  RS.fault_migrate_trace(cfgs[1], [1], [2]))
    pools = [mod.PagePool(cfg) for mod, cfg in zip((PS, RS), cfgs)]
    for pool in pools:
        pool.alloc(0, 0)
    assert pools[0].offline_bank(0) == pools[1].offline_bank(0)
    assert pools[0].state_dict() == pools[1].state_dict()
    sd = _sched(PS).state_dict()
    sd["dead_banks"] = [1]
    loaded = _sched(PS)
    loaded.load_state(sd)
    ref = _sched(RS)
    ref.load_state(sd)
    assert loaded.state_dict() == ref.state_dict() == sd

    # preemption's keywords run as the reference's on the same inputs: an
    # untripped guard and an unused checkpoint directory change nothing,
    # fresh requests with resume_from and a preemption with nowhere to
    # drain raise its ValueErrors
    from repro.runtime import PreemptionGuard as RGuard
    from repro_torch.runtime import PreemptionGuard
    eng = _engine()
    with PreemptionGuard(signals=()) as g, RGuard(signals=()) as rg:
        got = eng.run_scheduler(_requests(PS), guard=g,
                                checkpoint_dir=str(tmp_path / "p"))
        want = r_engine.run_scheduler(_requests(RS), guard=rg,
                                      checkpoint_dir=str(tmp_path / "r"))
    assert (got.ticks, got.stats, got.preempted, got.checkpoint) == (
        want.ticks, want.stats, want.preempted, want.checkpoint)
    for rid, toks in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], toks)
    for engine, mod in ((eng, PS), (r_engine, RS)):
        with pytest.raises(ValueError, match="requests=None"):
            engine.run_scheduler(_requests(mod),
                                 resume_from=str(tmp_path / "p"))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        eng.run_scheduler(_requests(PS), fault_plan=FaultPlan(
            (FaultEvent(tick=0, kind="preempt"),)))


@pytest.mark.parametrize("tick", [0, 1, 3, 4])
def test_chunked_live_preempt_resume_mid_prefill(tmp_path, r_engine, tick):
    """Live preemption of a day with 1-page prefill chunks, at tick 1 as
    the reference's test does and at the ticks after which a lane is mid
    prefill (0, 3 and 4, found by simulation): the resumed half re-derives
    the held K/V rows from the request's tokens, finishes with the
    uninterrupted chunked day's tokens (the reference's too), and the two
    halves' traces concatenate to the full chunked simulation."""
    from repro_torch.runtime import FaultEvent, FaultPlan
    reqs = _requests(PS)
    eng = _engine()
    baseline = eng.run_scheduler(reqs, prefill_chunk_pages=1).outputs
    want = r_engine.run_scheduler(_requests(RS),
                                  prefill_chunk_pages=1).outputs
    plan = FaultPlan((FaultEvent(tick=tick, kind="preempt"),))
    ck = str(tmp_path / "ck")
    part1 = eng.run_scheduler(reqs, fault_plan=plan, checkpoint_dir=ck,
                              prefill_chunk_pages=1)
    assert part1.preempted and part1.ticks == tick + 1
    aux = json.loads((tmp_path / "ck" / f"step_{tick + 1:08d}" /
                      "aux.json").read_text())
    assert bool(aux["sched"]["prefill_next"]) == (tick != 1)
    tr1 = eng.scheduler_stream().materialize()
    part2 = eng.run_scheduler(None, fault_plan=plan, resume_from=ck,
                              prefill_chunk_pages=1)
    assert not part2.preempted
    for r in reqs:
        np.testing.assert_array_equal(part2.outputs[r.rid], baseline[r.rid])
        np.testing.assert_array_equal(part2.outputs[r.rid], want[r.rid])
    full = PS.simulate_scheduler_stream(
        eng.mem_arch, reqs, n_lanes=4, max_seq=32, page_len=8,
        n_kv_layers=eng.n_kv_layers, fault_plan=plan,
        prefill_chunk_pages=1).materialize()
    _traces_equal(PTrace.concat(tr1, eng.scheduler_stream().materialize()),
                  full)
