"""The port's recoverable fault paths held to the JAX reference: the seeded
fault plans (``repro_torch.runtime``), the degraded ``!d`` memories and
their pricing (``core.arch``, ``core.cost_engine``), the scheduler's bank
loss, ECC page recovery and transient faults, the watchdog and the retry
primitive, and the live engine's chaos day.  A counterpart of every case of
``tests/test_faults.py`` (the symbolic prover's refusal of degraded
memories included), each compared with the reference's own result on the
same inputs (numpy seeds; the model weights converted with
``from_jax``), plus 64 degraded memories priced against the reference, 12
synthesized chaos days event for event, the serving bench's chaos pins,
the ``serve --fault-bank`` CLI, and preemption: days checkpointed by a
``preempt`` event or a tripped guard and resumed, in the port and across
the two packages.

Integers (page ids, traces, cycles, ticks, tokens) are compared exactly.
The live engines run float32 compute, where the port's greedy tokens equal
the reference's (``tests/test_torch_scheduler.py``)."""
import argparse
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import serving_bench as RBENCH  # noqa: E402
from repro import runtime as RR  # noqa: E402
from repro.analysis import validate as r_validate  # noqa: E402
from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core import arch as RA  # noqa: E402
from repro.core import cost_engine as RCE  # noqa: E402
from repro.core.trace import AddressTrace as RTrace  # noqa: E402
from repro.launch import serve as r_serve_cli  # noqa: E402
from repro.launch.sharding import NO_AXES  # noqa: E402
from repro.models import init_tree as r_init  # noqa: E402
from repro.models import model_specs as r_specs  # noqa: E402
from repro.serving import scheduler as RS  # noqa: E402
from repro.serving.engine import ServeEngine as RServe  # noqa: E402
from repro_torch import runtime as PR  # noqa: E402
from repro_torch.analysis import validate as p_validate  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.core import arch as PA  # noqa: E402
from repro_torch.core import cost_engine as PCE  # noqa: E402
from repro_torch.core.trace import (KIND_LOAD, KIND_STORE, LANES,  # noqa: E402
                                    AddressTrace)
from repro_torch.launch import serve as p_serve_cli  # noqa: E402
from repro_torch.launch.sharding import NO_AXES as P_NO_AXES  # noqa: E402
from repro_torch.models import from_jax, model_specs  # noqa: E402
from repro_torch.serving import scheduler as PS  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

CFG = get_smoke_config("llama3.2-1b")
RCFG = r_smoke("llama3.2-1b")
R_PARAMS = r_init(r_specs(RCFG), jax.random.PRNGKey(0))
PARAMS = from_jax(model_specs(CFG), jax.tree.map(np.asarray, R_PARAMS),
                  device="cpu")
P_RC = RunConfig(remat="none", attn_impl="dense", compute_dtype="float32")
R_RC = RRun(remat="none", attn_impl="dense", compute_dtype="float32")

#: the reference tests' pinned traffic, (arrival, prompt_len, max_new)
TRAFFIC = ((0, 12, 8), (0, 5, 6), (1, 8, 4), (2, 3, 0), (2, 9, 5),
           (3, 12, 3))
FIELDS = ("addrs", "kinds", "instr", "mask")


def _chaos_plan(mod):
    """The reference's chaos day (``tests/test_faults.py``): a bank dies
    mid-day, a resident page fails ECC, a decode step flakes twice."""
    return mod.FaultPlan((
        mod.FaultEvent(tick=3, kind="bank_offline", bank=1),
        mod.FaultEvent(tick=5, kind="page_corrupt", rid=0, page_idx=0),
        mod.FaultEvent(tick=6, kind="decode_transient", failures=2),
    ))


P_CHAOS, R_CHAOS = _chaos_plan(PR), _chaos_plan(RR)


def _requests(mod, spec=TRAFFIC, seed=0, tokens=True):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, arrival=a, prompt_len=p, max_new_tokens=m,
                        tokens=(rng.integers(0, CFG.vocab_size, p)
                                .astype(np.int32) if tokens else None))
            for i, (a, p, m) in enumerate(spec)]


def _sched(mod, arch="16B", n_lanes=4, max_seq=32, **kw):
    cfg = mod.scheduler_pool_config(arch, n_lanes, max_seq, 8)
    return mod.Scheduler(cfg, n_lanes=n_lanes, max_seq=max_seq, **kw)


def _plain(x):
    """Scheduler records as plain data: requests as their rid, arrays as
    lists, traces as (meta, addrs, kinds, instr, mask)."""
    if isinstance(x, (PS.Request, RS.Request)):
        return x.rid
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (AddressTrace, RTrace)):
        return (_plain(x.meta),) + tuple(
            None if getattr(x, f) is None else np.asarray(getattr(x, f))
            .tolist() for f in FIELDS)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _event(ev) -> dict:
    return _plain({
        "tick": ev.tick, "decoded": ev.decoded,
        "admitted": [(a.request, a.lane, a.page_ids) for a in ev.admitted],
        "completed": [(c.request, c.lane, c.tick, c.cancelled)
                      for c in ev.completed],
        "prefill_chunks": ev.prefill_chunks, "page_table": ev.page_table,
        "pos": ev.pos, "active": ev.active, "traces": ev.traces,
        "migrations": ev.migrations, "recoveries": ev.recoveries,
        "transients": ev.transients, "preempt": ev.preempt})


def _traces_equal(got, want) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))


def _outcome(fn, *args, **kw):
    """``fn``'s result, or the exception type it raises."""
    try:
        return fn(*args, **kw)
    except (ValueError, KeyError, RuntimeError) as e:
        return ("raises", type(e).__name__)


# -- fault plans -------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(tick=0, kind="meteor_strike"), dict(tick=-1, kind="preempt"),
    dict(tick=0, kind="bank_offline"), dict(tick=0, kind="page_corrupt"),
    dict(tick=0, kind="decode_transient", failures=0),
    dict(tick=2, kind="bank_offline", bank=3),
    dict(tick=1, kind="page_corrupt", rid=4, page_idx=9),
    dict(tick=0, kind="decode_transient", failures=3)])
def test_fault_event_validation(kw):
    got, want = (_outcome(mod.FaultEvent, **kw) for mod in (PR, RR))
    if isinstance(want, tuple):
        assert got == want == ("raises", "ValueError")
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert PR.FAULT_KINDS == RR.FAULT_KINDS


def test_fault_plan_ordering_cursor_and_counts():
    for mod in (PR, RR):
        with pytest.raises(ValueError):
            mod.FaultPlan((mod.FaultEvent(tick=5, kind="preempt"),
                           mod.FaultEvent(tick=2, kind="preempt")))
    assert len(P_CHAOS) == len(R_CHAOS) == 3
    assert P_CHAOS.counts() == R_CHAOS.counts() == {
        "bank_offline": 1, "page_corrupt": 1, "decode_transient": 1}
    assert not P_CHAOS.has_preempt
    assert PR.FaultPlan((PR.FaultEvent(tick=1, kind="preempt"),)).has_preempt
    cur = {PR: 0, RR: 0}
    for now in (2, 3, 9, 99):
        kinds = {}
        for mod, plan in ((PR, P_CHAOS), (RR, R_CHAOS)):
            evs, cur[mod] = plan.due(now, cur[mod])
            kinds[mod] = [e.kind for e in evs]
        assert kinds[PR] == kinds[RR] and cur[PR] == cur[RR]
    # an idle fast-forward past ticks 5 and 6 fired both, in order
    assert cur[PR] == 3 and P_CHAOS.due(99, 3) == ((), 3)
    assert [e.kind for e in P_CHAOS] == [e.kind for e in R_CHAOS]


@pytest.mark.parametrize("seed", [0, 11, 12, 99])
def test_synthesize_is_seeded_and_scratch_safe(seed):
    kw = dict(n_events=4, horizon=16, n_banks=16)
    a = PR.FaultPlan.synthesize(seed=seed, **kw)
    assert a.events == PR.FaultPlan.synthesize(seed=seed, **kw).events
    assert a.events != PR.FaultPlan.synthesize(seed=seed + 1, **kw).events
    assert [dataclasses.asdict(e) for e in a] == [
        dataclasses.asdict(e) for e in RR.FaultPlan.synthesize(seed=seed,
                                                               **kw)]
    ticks = [e.tick for e in a]
    assert ticks == sorted(ticks) and all(1 <= t < 16 for t in ticks)
    # the last bank hosts the reserved scratch page: never offlined
    assert all(e.bank < 15 for e in a)


# -- degraded architecture variants ------------------------------------------

def test_degraded_name_round_trips_but_is_never_registered():
    for mod in (PA, RA):
        deg = mod.get("16B-xor").degrade((1, 3))
        assert deg.name == "16B-xor!d1+3" and deg.dead_banks == (1, 3)
        assert mod.resolve("16B-xor!d1+3").spec == deg.spec
        assert deg.base.name == "16B-xor"
        # degrading a degraded memory flattens into one canonical variant
        assert deg.degrade((2,)).name == "16B-xor!d1+2+3"
        assert not any("!d" in n for n in mod.names())
        for bad in ("16B-xor!d3+1", "16B-xor!d99", "4R-2W!d0",
                    "16B!d1!d2", "4B!d0+1+2+3"):
            with pytest.raises(KeyError):
                mod.get(bad)
        with pytest.raises(ValueError, match="not banked"):
            mod.DegradedBankedMemory(mod.get("4R-2W").spec, (0,))
        with pytest.raises(ValueError, match="dead bank"):
            mod.DegradedBankedMemory(mod.get("16B").spec, ())
        with pytest.raises(ValueError, match="out of range"):
            mod.get("8B").degrade((8,))
    assert dataclasses.asdict(PA.get("16B-xor!d1+3").spec) == (
        dataclasses.asdict(RA.get("16B-xor!d1+3").spec))
    two = PA.get("4x4B-g64").degrade((5,))
    assert two.name == "4x4B-g64!d5" and two.layout is None
    assert dataclasses.asdict(two.spec) == dataclasses.asdict(
        RA.get("4x4B-g64").degrade((5,)).spec)
    assert PA.resolve(two.spec).name == two.name


@pytest.mark.parametrize("name", ["16B-xor!d1+3", "8B!d0+5", "12B!d11",
                                  "6B-offset!d2", "4x4B-g64!d0+15",
                                  "4x3B!d4", "16B-bcast!d7"])
def test_surviving_bank_remap_and_banks_of(name):
    p, r = PA.get(name), RA.get(name)
    remap = p.bank_remap()
    assert remap == r.bank_remap() == PA.surviving_bank_remap(
        p.total_banks, p.dead_banks)
    for d in p.dead_banks:
        assert remap[d] not in p.dead_banks     # next surviving neighbor
    addrs = np.arange(4096, dtype=np.int32)
    banks = p.banks_of(torch.from_numpy(addrs)).numpy()
    np.testing.assert_array_equal(banks, np.asarray(r.banks_of(addrs)))
    assert not np.isin(banks, p.dead_banks).any()
    assert RA.surviving_bank_remap(16, (1, 3))[1] == 2
    for args in ((16, (16,)), (4, (0, 1, 2, 3))):
        with pytest.raises(ValueError):
            PA.surviving_bank_remap(*args)


def _mixed_trace(n_ops=48, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 4096, size=(n_ops, LANES)).astype(np.int32)
    kinds = np.where(rng.random(n_ops) < 0.3, KIND_STORE,
                     KIND_LOAD).astype(np.int8)
    mask = rng.random((n_ops, LANES)) < 0.8 if masked else None
    instr = np.sort(rng.integers(0, n_ops // 3, n_ops)).astype(np.int32)
    return (AddressTrace(addrs, kinds, instr, mask=mask),
            RTrace(addrs, kinds, instr, mask=mask))


def _totals(costs):
    return [dataclasses.asdict(c) for c in costs]


def test_cost_many_prices_degraded_variants_bit_exactly():
    """The batched path applies the surviving-bank remap as the single-arch
    loop does, across a mixed healthy / degraded lattice of different bank
    widths, and equals the reference."""
    p_tr, r_tr = _mixed_trace()
    names = ["16B-xor", "16B-xor!d1", "8B!d0+5", "4B-fold!d2", "4R-2W"]
    batched = PCE.cost_many(names, p_tr, device="cpu")
    for name, got in zip(names, batched):
        assert got == PA.get(name)._cost_loop(p_tr, device="cpu"), name
        assert got.total_cycles == PA.get(name).cost(
            p_tr, device="cpu").total_cycles
    assert _totals(batched) == _totals(RCE.cost_many(names, r_tr))
    # fewer banks to arbitrate over can never be cheaper
    assert batched[1].total_cycles >= batched[0].total_cycles


#: healthy bases of every family the remap covers: all four maps, non-pow2
#: counts, broadcast, the offset shift and two-level shapes
DEGRADE_BASES = ("16B", "16B-offset", "16B-xor", "16B-fold", "8B", "8B-xor",
                 "4B", "4B-offset", "32B-xor", "12B", "6B-offset",
                 "16B-offset-s2", "16B-bcast", "4x4B-g64", "2x8B-g32",
                 "4x3B")


def _degraded_names(n_per_base=4, seed=7):
    """1-3 dead banks, seeded, per base; canonical names."""
    rng = np.random.default_rng(seed)
    out: list = []
    for base in DEGRADE_BASES:
        total = PA.get(base).total_banks
        i = 0
        while i < n_per_base:
            dead = sorted(rng.choice(total, size=1 + i % 3,
                                     replace=False).tolist())
            name = f"{base}!d" + "+".join(map(str, dead))
            if name not in out:
                out.append(name)
                i += 1
    return out


DEGRADED = _degraded_names()


def test_degraded_lattice_lowering_equals_the_reference():
    """The lowered table of 64 degraded variants and their bases: params,
    remaps (identity-padded to the widest flat bank count), overheads and
    static flags are the reference's; a healthy lattice takes no remap, and
    the digest keys every degraded variant apart from its base."""
    assert len(DEGRADED) == 64 and len(set(DEGRADED)) == 64
    for names in (DEGRADED, list(DEGRADE_BASES), ["16B", "16B!d3"]):
        p, r = PCE.lower_archs(names), RCE.lower_archs(names)
        np.testing.assert_array_equal(p.params, r.params)
        np.testing.assert_array_equal(p.remaps, r.remaps)
        np.testing.assert_array_equal(p.overheads, r.overheads)
        assert ((p.need_uniq, p.need_remap, p.need_mod, p.need_two_level)
                == (r.need_uniq, r.need_remap, r.need_mod,
                    r.need_two_level))
    assert not PCE.lower_archs(list(DEGRADE_BASES)).need_remap
    assert PCE.lower_archs(["16B!d3"]).need_remap
    digests = {PCE.lower_archs([n]).digest for n in DEGRADED}
    digests |= {PCE.lower_archs([n]).digest for n in DEGRADE_BASES}
    assert len(digests) == len(DEGRADED) + len(DEGRADE_BASES)


@pytest.mark.parametrize("masked", [False, True])
def test_degraded_lattice_prices_equal_the_reference(masked):
    """64 degraded variants priced in one ``cost_many`` pass, cold and warm
    through a ``BlockCostCache``, and one by one through ``_cost_loop``:
    every ``TraceCost`` is the reference's, bit for bit; none is cheaper
    than its healthy base."""
    p_tr, r_tr = _mixed_trace(n_ops=96, seed=int(masked), masked=masked)
    want = _totals(RCE.cost_many(DEGRADED, r_tr))
    assert _totals(PCE.cost_many(DEGRADED, p_tr, device="cpu")) == want
    cache = PCE.BlockCostCache()
    cold = PCE.cost_many(DEGRADED, p_tr, device="cpu", cache=cache)
    warm = PCE.cost_many(DEGRADED, p_tr, device="cpu", cache=cache)
    assert cache.hits > 0 and _totals(cold) == _totals(warm) == want
    assert _totals(PA.get(n)._cost_loop(p_tr, device="cpu")
                   for n in DEGRADED) == want
    # a cache warmed on the healthy bases returns their cost, never a
    # degraded variant's: the digests key them apart
    bases = [n.split("!d")[0] for n in DEGRADED]
    healthy = PCE.cost_many(bases, p_tr, device="cpu", cache=cache)
    assert _totals(healthy) == _totals(RCE.cost_many(bases, r_tr))
    for b, d in zip(healthy, cold):
        assert d.total_cycles >= b.total_cycles


def test_symbolic_prover_rejects_degraded_specs():
    """The prover refuses a degraded memory, as the reference's does, with
    the reference's message."""
    from repro.analysis.symbolic import prove as r_prove
    from repro.isa.programs import transpose as r_tr_prog
    from repro_torch.analysis.symbolic import prove
    from repro_torch.isa.programs import transpose as tr_prog
    with pytest.raises(NotImplementedError, match="degraded") as got:
        prove(PA.get("16B-xor").degrade((3,)), tr_prog.symbolic_trace(64))
    with pytest.raises(NotImplementedError) as want:
        r_prove(RA.get("16B-xor").degrade((3,)),
                r_tr_prog.symbolic_trace(64))
    assert str(got.value) == str(want.value)


def test_serving_bench_chaos_pins_hold():
    """The reference serving bench's chaos gate on the port: its pinned
    traffic under its fault plan, priced healthy / faulted / faulted on the
    degraded variant, gives ``CHAOS_CYCLES`` (2800 / 4660 / 4668)."""
    reqs = _requests(PS, RBENCH.CHECK_TRAFFIC, tokens=False)
    base = PA.get(RBENCH.CHAOS_ARCH)
    deg = base.degrade(RBENCH.CHAOS_DEAD_BANKS)
    plan = PR.FaultPlan((
        PR.FaultEvent(tick=3, kind="bank_offline",
                      bank=RBENCH.CHAOS_DEAD_BANKS[0]),
        PR.FaultEvent(tick=5, kind="page_corrupt", rid=0, page_idx=0),
        PR.FaultEvent(tick=6, kind="decode_transient", failures=2)))
    assert [dataclasses.asdict(e) for e in plan] == [
        dataclasses.asdict(e) for e in RBENCH.chaos_plan()]
    kw = dict(n_lanes=4, max_seq=32, page_len=RBENCH.PAGE_LEN,
              n_kv_layers=RBENCH.N_KV_LAYERS)
    healthy = PS.simulate_scheduler_stream(base, reqs, **kw)
    faulted = PS.simulate_scheduler_stream(base, reqs, fault_plan=plan, **kw)
    rep = p_validate(faulted, arch=base.name, block_ops=64)
    assert rep.ok and rep.n_ops == p_validate(faulted, arch=base.name,
                                              block_ops=64).n_ops
    f_base, f_deg = PCE.cost_many([base, deg], faulted, device="cpu")
    cycles = {"healthy": PCE.cost_many([base], healthy,
                                       device="cpu")[0].total_cycles,
              "faulted": f_base.total_cycles,
              "faulted_degraded": f_deg.total_cycles}
    assert cycles == RBENCH.CHAOS_CYCLES == {
        "healthy": 2800, "faulted": 4660, "faulted_degraded": 4668}
    assert deg.name == "16B-xor!d1"


# -- page pool bank loss -----------------------------------------------------

def test_pool_offline_bank_evicts_live_and_poisons_free_slots():
    out = {}
    for mod in (PS, RS):
        cfg = mod.scheduler_pool_config("16B", 4, 64, 8)
        pool = mod.PagePool(cfg, policy="seq-skew")
        ids = [pool.alloc(k, seq) for seq in range(4) for k in range(4)]
        lay = cfg.layout
        on_b1 = sorted(p for p in ids
                       if int(np.asarray(lay.bank_slot(np.asarray(p))[0]))
                       == 1)
        free_before = pool.n_free
        dead = pool.offline_bank(1)
        assert dead == on_b1                         # live ids, ascending
        # the dead bank's free slots leave the pool too
        assert pool.n_free == free_before - (cfg.n_pages // 16 - len(dead))
        assert pool.offline_bank(1) == []            # idempotent
        with pytest.raises(ValueError):
            pool.offline_bank(99)
        with pytest.raises(ValueError):              # never double-freed
            pool.release([dead[0]])
        later = [pool.alloc(k, 1) for k in range(8)]
        assert all(int(np.asarray(lay.bank_slot(np.asarray(p))[0])) != 1
                   for p in later)
        sd = pool.state_dict()
        fresh = mod.PagePool(cfg, policy="seq-skew")
        fresh.load_state(json.loads(json.dumps(sd)))
        assert fresh.state_dict() == sd and fresh.offline == {1}
        out[mod] = (dead, later, sd)
    assert out[PS] == out[RS]


def test_scratch_bank_offline_is_rejected():
    for mod, fr in ((PS, PR), (RS, RR)):
        plan = fr.FaultPlan((fr.FaultEvent(tick=0, kind="bank_offline",
                                           bank=15),))
        s = _sched(mod, fault_plan=plan)
        s.submit(_requests(mod, ((0, 4, 2),), tokens=False))
        with pytest.raises(ValueError, match="scratch"):
            s.tick()


def test_bank_offline_with_no_live_pages_emits_no_migration_traffic():
    got = {}
    for mod, fr in ((PS, PR), (RS, RR)):
        plan = fr.FaultPlan((fr.FaultEvent(tick=0, kind="bank_offline",
                                           bank=2),))
        s = _sched(mod, fault_plan=plan)
        s.submit(_requests(mod, ((2, 4, 2),), tokens=False))
        ev = s.tick()
        assert ev.migrations and ev.migrations[0]["old_ids"] == []
        assert not any(t.meta.get("what") == "fault_migrate"
                       for t in ev.traces)
        assert s.dead_banks == (2,)
        got[mod] = (_event(ev), s.stats()["faults"])
    assert got[PS] == got[RS]


def test_fault_migrate_trace_validates_id_counts():
    cfgs = [mod.scheduler_pool_config("16B", 4, 32, 8) for mod in (PS, RS)]
    t = PS.fault_migrate_trace(cfgs[0], [3, 4], [7, 9], n_kv_layers=2,
                               bank=1)
    assert t.meta["what"] == "fault_migrate" and t.n_ops == 8
    assert _plain(t) == _plain(RS.fault_migrate_trace(
        cfgs[1], [3, 4], [7, 9], n_kv_layers=2, bank=1))
    with pytest.raises(ValueError):
        PS.fault_migrate_trace(cfgs[0], [3, 4], [7])


# -- simulated chaos days ----------------------------------------------------

@pytest.mark.parametrize("arch", ("16B-xor", "4R-2W"))
@pytest.mark.parametrize("plan_name", ("explicit", "synthesized"))
def test_sim_chaos_day_completes_validates_and_reiterates(arch, plan_name):
    """The chaos matrix: every faulted day completes all requests, passes
    the trace contract with the reference's report, replays bit-identically
    on re-iteration, leaks no pages, and every event is the reference's."""
    plans = {mod: (plan if plan_name == "explicit" else
                   fr.FaultPlan.synthesize(seed=11, n_events=3, horizon=7,
                                           n_banks=16, n_rids=6))
             for mod, fr, plan in ((PS, PR, P_CHAOS), (RS, RR, R_CHAOS))}
    reqs = {mod: _requests(mod, tokens=False) for mod in (PS, RS)}
    kw = dict(n_lanes=4, max_seq=32, page_len=8)
    stream = PS.simulate_scheduler_stream(arch, reqs[PS],
                                          fault_plan=plans[PS], **kw)
    want = RS.simulate_scheduler_stream(arch, reqs[RS],
                                        fault_plan=plans[RS], **kw)
    assert stream.meta == want.meta
    assert stream.meta["faults"] == plans[PS].counts()
    rep1 = p_validate(stream, arch=arch, block_ops=64)
    rep2 = p_validate(stream, arch=arch, block_ops=64)   # a fresh replay
    assert rep1.ok, rep1.violations
    assert dataclasses.asdict(rep1) == dataclasses.asdict(rep2) == (
        dataclasses.asdict(r_validate(want, arch=arch, block_ops=64)))
    t1, t2 = stream.materialize(), stream.materialize()
    _traces_equal(t1, t2)
    _traces_equal(t1, want.materialize())

    out = {}
    for mod in (PS, RS):
        s = _sched(mod, arch, fault_plan=plans[mod])
        events = list(s.run(reqs[mod]))
        comp = sorted(c.request.rid for e in events for c in e.completed)
        assert comp == [0, 1, 2, 3, 4, 5]                 # nobody dropped
        n_dead = len(s.dead_banks)
        # no page leaks: free = everything but dead banks and the scratch
        assert s.pool.n_free == (s.pool.free.size
                                 - n_dead * s.pool.free.shape[1] - 1)
        whats = [t.meta.get("what") for e in events for t in e.traces]
        if any(e.kind == "bank_offline" for e in plans[mod]):
            assert "sched_decode_degraded" in whats
        st = s.stats()["faults"]
        assert st["degraded"] == (n_dead > 0)
        assert st["dead_banks"] == list(s.dead_banks)
        out[mod] = ([_event(e) for e in events], s.stats(), s.state_dict())
    assert out[PS] == out[RS]


CHAOS_ARCHS = ("16B", "16B-xor", "8B", "4R-2W")


@pytest.mark.parametrize("seed", range(12))
def test_synthesized_chaos_days_equal_the_reference(seed):
    """12 seeded days under ``FaultPlan.synthesize`` (preemption marks in
    a third of them, chunked prefill in half): every TickEvent (migrations
    and recovery records included), ``stats()``, ``state_dict()`` and the
    simulated stream are the reference's, bit for bit."""
    rng = np.random.default_rng(500 + seed)
    n_lanes = int(rng.integers(2, 9))
    max_seq = int(rng.choice([32, 64, 128]))
    arch = CHAOS_ARCHS[seed % 4]
    chunk = (None, 2)[seed % 2]
    kinds = (("bank_offline", "page_corrupt", "decode_transient", "preempt")
             if seed % 3 == 0 else
             ("bank_offline", "page_corrupt", "decode_transient"))
    n_req = int(rng.integers(6, 24))
    day = {mod: mod.synthesize_requests(n_req, 1.5, "mixed", max_seq=max_seq,
                                        seed=seed) for mod in (PS, RS)}
    plan_kw = dict(seed=seed, n_events=int(rng.integers(3, 7)),
                   horizon=int(rng.integers(8, 24)), kinds=kinds,
                   n_banks=16, n_rids=n_req, max_failures=3)
    plans = {PS: PR.FaultPlan.synthesize(**plan_kw),
             RS: RR.FaultPlan.synthesize(**plan_kw)}
    out = {}
    for mod in (PS, RS):
        s = _sched(mod, arch, n_lanes=n_lanes, max_seq=max_seq,
                   n_kv_layers=2, fault_plan=plans[mod],
                   prefill_chunk_pages=chunk)
        out[mod] = ([_event(e) for e in s.run(day[mod])], s.stats(),
                    s.state_dict())
    assert out[PS] == out[RS]
    kw = dict(n_lanes=n_lanes, max_seq=max_seq, n_kv_layers=2,
              prefill_chunk_pages=chunk)
    got = PS.simulate_scheduler_stream(arch, day[PS], fault_plan=plans[PS],
                                       **kw)
    want = RS.simulate_scheduler_stream(arch, day[RS], fault_plan=plans[RS],
                                        **kw)
    _traces_equal(got.materialize(), want.materialize())
    assert got.meta == want.meta


def test_scheduler_state_roundtrips_and_resumes_identically():
    """A mid-fault ``state_dict`` is the reference's JSON, and a fresh
    scheduler of either package loaded from it finishes the day (the
    remaining faults included) with the original's traces, completions and
    counters."""
    sds = {}
    for mod, plan in ((PS, P_CHAOS), (RS, R_CHAOS)):
        s1 = _sched(mod, "16B-xor", fault_plan=plan)
        s1.submit(_requests(mod, tokens=False))
        for _ in range(4):
            s1.tick()
        sds[mod] = (s1, s1.state_dict())
    assert json.dumps(sds[PS][1]) == json.dumps(sds[RS][1])
    blob = json.dumps(sds[PS][1])
    assert sds[PS][1]["dead_banks"] == [1]
    tails = []
    for mod, plan in ((PS, P_CHAOS), (RS, R_CHAOS)):
        s1 = sds[mod][0]
        s2 = _sched(mod, "16B-xor", fault_plan=plan)
        s2.load_state(json.loads(blob))
        e1 = [_event(e) for e in s1.run()]
        e2 = [_event(e) for e in s2.run()]
        assert e1 == e2
        assert s1.pool.n_free == s2.pool.n_free
        assert s1.stats()["faults"] == s2.stats()["faults"]
        tails.append((e2, s2.stats()))
    assert tails[0] == tails[1]


def test_scheduler_load_state_rejects_mismatched_shapes():
    s = _sched(PS)
    sd = s.state_dict()
    with pytest.raises(ValueError, match="lanes"):
        _sched(PS, n_lanes=8).load_state(sd)
    small = _sched(PS, n_lanes=2, max_seq=16)
    with pytest.raises(ValueError, match="pool"):
        small.pool.load_state(sd["pool"])


# -- the watchdog in the scheduler -------------------------------------------

def _watched_run(mod, fr):
    clock = {"t": 0.0, "step": 0.1}

    def timer():
        t = clock["t"]
        clock["t"] += clock["step"]
        return t

    hits = []
    wd = fr.StepWatchdog(
        threshold=3.0, on_straggler=lambda step, sec, med: hits.append(step))
    s = _sched(mod, n_lanes=2, watchdog=wd, timer=timer)
    s.submit([mod.Request(0, 0, prompt_len=4, max_new_tokens=16)])
    decoded = 0
    while not s.done():
        if s.tick().decoded:
            decoded += 1
            if decoded == 10:
                clock["step"] = 10.0          # every later tick is 100x
    return wd, s.stats(), hits, decoded


def test_watchdog_flags_straggler_decode_ticks():
    """Each decode step is timed through an injectable timer; once the
    median settles, 100x-slower ticks are flagged, recorded in ``stats()``
    and the caller's callback still fires, as in the reference."""
    wd, st, hits, decoded = _watched_run(PS, PR)
    assert len(wd.times) == decoded           # only decode ticks observed
    assert wd.stragglers == 5 and st["stragglers"] == 5
    assert st["straggler_ticks"] == hits and len(hits) == 5
    r_wd, r_st, r_hits, _ = _watched_run(RS, RR)
    assert (st, hits, wd.times) == (r_st, r_hits, r_wd.times)


def test_scheduler_without_watchdog_reports_no_straggler_stats():
    for mod in (PS, RS):
        s = _sched(mod, n_lanes=2)
        list(s.run([mod.Request(0, 0, prompt_len=4, max_new_tokens=3)]))
        assert "stragglers" not in s.stats()


# -- retry_step --------------------------------------------------------------

def _retry_sleeps(fr, seed, fail=2):
    sleeps, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= fail:
            raise RuntimeError("transient")
        return "ok"

    out = fr.retry_step(flaky, retries=4, backoff=0.1, jitter=0.5, seed=seed,
                        _sleep=sleeps.append)
    return out, sleeps


def test_retry_jitter_is_deterministic_per_seed():
    o1, s1 = _retry_sleeps(PR, 7)
    o2, s2 = _retry_sleeps(PR, 7)
    assert o1 == o2 == "ok"
    assert s1 == s2 and len(s1) == 2          # same schedule, same seed
    assert 0.1 < s1[0] < 0.15                 # jitter scaled into [1, 1.5)x
    assert 0.2 < s1[1] < 0.3
    assert s1 == _retry_sleeps(RR, 7)[1]


def test_retry_jitter_seed_changes_schedule():
    assert _retry_sleeps(PR, 7)[1] != _retry_sleeps(PR, 8)[1]
    for seed in (8, 9):
        assert _retry_sleeps(PR, seed, 4)[1] == _retry_sleeps(RR, seed, 4)[1]
    with pytest.raises(RuntimeError, match="transient"):
        _retry_sleeps(PR, 7, fail=5)         # 4 retries, 5 failures


def test_retry_max_elapsed_caps_the_budget():
    """With backoff 1 s doubling and a 3 s budget, attempts run at t = 0, 1
    and 3, and the 4 s sleep that would follow busts the cap: 3 calls,
    though 11 were allowed."""
    calls = {}
    for fr in (PR, RR):
        clock = {"t": 0.0}
        n = {"calls": 0}

        def always_fails(n=n):
            n["calls"] += 1
            raise RuntimeError("persistent")

        with pytest.raises(RuntimeError, match="persistent"):
            fr.retry_step(always_fails, retries=10, backoff=1.0,
                          max_elapsed=3.0,
                          _sleep=lambda d, c=clock: c.__setitem__(
                              "t", c["t"] + d),
                          _clock=lambda c=clock: c["t"])
        calls[fr] = n["calls"]
    assert calls[PR] == calls[RR] == 3


def test_watchdog_flags_stragglers():
    """``tests/test_runtime.py``'s watchdog case on both packages."""
    for fr in (PR, RR):
        wd = fr.StepWatchdog(threshold=2.0)
        for i in range(10):
            wd.observe(i, 0.1)
        assert wd.observe(10, 0.5) is True
        assert wd.stragglers == 1
        assert wd.observe(11, 0.11) is False


def test_retry_step_recovers():
    """``tests/test_runtime.py``'s retry case on both packages."""
    for fr in (PR, RR):
        calls = {"n": 0}

        def flaky(calls=calls):
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("transient")
            return 42
        assert fr.retry_step(flaky, retries=3, backoff=0.0) == 42
        assert calls["n"] == 3


def test_transient_fault_is_a_runtime_error_and_the_guard_stops():
    assert issubclass(PR.TransientFault, RuntimeError)
    with PR.PreemptionGuard(signals=()) as g:    # no handler installed
        assert not g.should_stop
        g._handler(15, None)
        assert g.should_stop


# -- the live engine under faults --------------------------------------------

def _engine(**kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 32)
    kw.setdefault("page_len", 8)
    kw.setdefault("mem_arch", "16B-xor")
    return ServeEngine(CFG, P_RC, PARAMS, P_NO_AXES,
                       kv_mode="paged", device="cpu",
                       **kw)


@pytest.fixture(scope="module")
def eng():
    return _engine()


@pytest.fixture(scope="module")
def r_eng():
    return RServe(RCFG, R_RC, R_PARAMS, NO_AXES, max_batch=4, max_seq=32,
                  page_len=8, kv_mode="paged", mem_arch="16B-xor")


@pytest.fixture(scope="module")
def baseline(eng):
    """The port's uninterrupted day, which every faulted run is held to."""
    res = eng.run_scheduler(_requests(PS))
    return {rid: np.asarray(v).copy() for rid, v in res.outputs.items()}


def test_live_chaos_day_is_token_pinned_and_bit_equal_to_sim(eng, r_eng,
                                                             baseline):
    """A day with a bank loss, an ECC page corruption and transient decode
    faults completes every request with the healthy day's tokens and the
    reference's live tokens; its fault counters are the reference's; its
    recorded trace (migration burst, re-prefill, replay and degraded decode
    blocks) is bit-equal to the port's and the reference's simulation of
    the same plan and to the reference's live trace; the degraded variant
    prices it at no less than the healthy memory."""
    reqs = _requests(PS)
    res = eng.run_scheduler(reqs, fault_plan=P_CHAOS)
    want = r_eng.run_scheduler(_requests(RS), fault_plan=R_CHAOS)
    assert not res.preempted and res.checkpoint is None
    for r in reqs:
        np.testing.assert_array_equal(res.outputs[r.rid], baseline[r.rid])
        np.testing.assert_array_equal(res.outputs[r.rid],
                                      want.outputs[r.rid])
    assert res.stats == want.stats and res.ticks == want.ticks
    f = res.stats["faults"]
    assert f["dead_banks"] == [1] and f["degraded"]
    assert f["recoveries"] == 1 and f["transients"] == 2
    assert f["migrated_pages"] > 0

    live = eng.scheduler_stream()
    rep = p_validate(live, arch=eng.mem_arch.name, block_ops=64)
    assert rep.ok, rep.violations
    lt = live.materialize()
    whats = [b.meta.get("what") for b in live]
    assert {"fault_migrate", "fault_reprefill",
            "sched_decode_degraded"} <= set(whats)
    assert any(b.meta.get("replay") for b in live)
    kw = dict(n_lanes=4, max_seq=32, page_len=8, n_kv_layers=eng.n_kv_layers)
    _traces_equal(lt, PS.simulate_scheduler_stream(
        eng.mem_arch, reqs, fault_plan=P_CHAOS, **kw).materialize())
    _traces_equal(lt, RS.simulate_scheduler_stream(
        r_eng.mem_arch, _requests(RS), fault_plan=R_CHAOS,
        **kw).materialize())
    _traces_equal(lt, r_eng.scheduler_stream().materialize())
    deg = eng.mem_arch.degrade((1,))
    healthy_c, deg_c = eng.scheduler_cost([eng.mem_arch, deg])
    assert deg_c.total_cycles >= healthy_c.total_cycles
    assert [c.total_cycles for c in (healthy_c, deg_c)] == [
        c.total_cycles for c in r_eng.scheduler_cost(
            [r_eng.mem_arch, r_eng.mem_arch.degrade((1,))])]


def test_recovery_replays_every_decode_step_and_diverging_raises(eng):
    """The recovery rebuilds the victim from its prompt and its recorded
    tokens: a wrong recorded token makes the replay diverge, and the run
    raises instead of finishing with a silently different answer."""
    reqs = _requests(PS)
    s = _sched(PS, "16B-xor", fault_plan=P_CHAOS)
    recs = [r for e in s.run(reqs) for r in e.recoveries]
    assert len(recs) == 1 and not recs[0]["skipped"]
    assert recs[0]["steps"] >= 1                 # at least one replay step
    orig = eng._scheduler_step
    calls = {"n": 0}

    def poisoned(params, tok, pools, *args):
        calls["n"] += 1
        logits, pools = orig(params, tok, pools, *args)
        if calls["n"] == 1:
            # the first replay step of the victim (lane 0) decodes another
            # token than the one recorded for it
            logits = logits.clone()
            logits[0, -1, :] = 0
            logits[0, -1, 1] = 1
        return logits, pools

    res = eng.run_scheduler(reqs)
    toks = {rid: list(v) for rid, v in res.outputs.items()}
    assert toks[0][1] != 1
    rec = recs[0]
    eng._scheduler_step = poisoned
    try:
        pools = {key: {h: p.clone() for h, p in pair.items()}
                 for key, pair in eng.last_pools.items()}
        with pytest.raises(RuntimeError, match="diverged"):
            eng._recover_page(pools, rec, toks,
                              np.zeros(4, np.int64), 0)
    finally:
        del eng._scheduler_step


def test_lost_page_zeroes_its_own_line(eng):
    """An ECC fault zeroes the page's own line, at the physical row its
    logical id maps to in the bank-major pools, and nothing else."""
    kv = eng.kv_cfg
    gen = torch.Generator().manual_seed(0)
    pools = {"b0s0": {h: torch.rand((kv.n_pages, 4), generator=gen) + 1
                      for h in ("k", "v")}}
    before = {h: p.clone() for h, p in pools["b0s0"].items()}
    pid = 21
    row = int(kv.layout.physical_row(pid, kv.n_pages))
    assert row != pid                            # 16B-xor moves the row
    eng._lose_page(pools, pid)
    for h, p in pools["b0s0"].items():
        assert not p[row].any()
        keep = torch.ones(kv.n_pages, dtype=torch.bool)
        keep[row] = False
        assert torch.equal(p[keep], before[h][keep])


def test_preemption_without_checkpoint_dir_raises(eng, r_eng, tmp_path):
    """A preemption with nowhere to drain raises the reference's
    ``ValueError`` naming ``checkpoint_dir``, whether a ``preempt`` event
    or a tripped guard fires it; ``guard=``, ``checkpoint_dir=`` and
    ``resume_from=`` otherwise run as the reference's do."""
    for engine, mod, fr in ((eng, PS, PR), (r_eng, RS, RR)):
        plan = fr.FaultPlan((fr.FaultEvent(tick=4, kind="preempt"),))
        with pytest.raises(ValueError, match="checkpoint_dir"):
            engine.run_scheduler(_requests(mod), fault_plan=plan)
        with fr.PreemptionGuard(signals=()) as g:
            g._handler(15, None)
            with pytest.raises(ValueError, match="checkpoint_dir"):
                engine.run_scheduler(_requests(mod), guard=g)
    # an untripped guard and an unused checkpoint directory change nothing
    with PR.PreemptionGuard(signals=()) as g:
        got = eng.run_scheduler(_requests(PS), guard=g,
                                checkpoint_dir=str(tmp_path / "p"))
    want = r_eng.run_scheduler(_requests(RS),
                               checkpoint_dir=str(tmp_path / "r"))
    assert not got.preempted and got.checkpoint is None
    assert got.ticks == want.ticks and got.stats == want.stats
    for rid, toks in want.outputs.items():
        np.testing.assert_array_equal(got.outputs[rid], toks)
    assert not (tmp_path / "p").exists() and not (tmp_path / "r").exists()
    # resume_from: with fresh requests, from an empty or missing directory,
    # from a checkpoint with no scheduler sidecar
    from repro_torch.checkpoint import save_checkpoint
    (tmp_path / "empty").mkdir()
    save_checkpoint(str(tmp_path / "bare"), 1, {"x": torch.zeros(1)})
    for engine, mod in ((eng, PS), (r_eng, RS)):
        with pytest.raises(ValueError, match="resum"):
            engine.run_scheduler(_requests(mod),
                                 resume_from=str(tmp_path / "empty"))
        for d in ("empty", "missing"):
            with pytest.raises(ValueError, match="no checkpoint found"):
                engine.run_scheduler(None, resume_from=str(tmp_path / d))
    with pytest.raises(ValueError, match="disagree"):
        eng.run_scheduler(None, resume_from=str(tmp_path / "bare"))


# -- preemption: checkpoint, resume ------------------------------------------

def _preempt_plan(mod, tick):
    return mod.FaultPlan((mod.FaultEvent(tick=tick, kind="preempt"),))


def _halves_equal_the_full_day(eng, reqs, plan, tr1, tr2, **kw) -> None:
    full = PS.simulate_scheduler_stream(
        eng.mem_arch, reqs, n_lanes=4, max_seq=32, page_len=8,
        n_kv_layers=eng.n_kv_layers, fault_plan=plan, **kw).materialize()
    _traces_equal(AddressTrace.concat(tr1, tr2), full)


def test_live_preemption_checkpoint_resume_is_pinned(eng, baseline,
                                                     tmp_path):
    """Preempt mid-day, checkpoint, resume in a second call: the merged
    outputs equal the uninterrupted run, the two halves' traces
    concatenate to the full simulated day, the first half's pools are the
    checkpoint's bit for bit, and ``lane_tok`` is saved in the reference's
    (max_batch, 1) int32 form."""
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    reqs = _requests(PS)
    plan = _preempt_plan(PR, 4)
    ck = str(tmp_path / "ck")
    part1 = eng.run_scheduler(reqs, fault_plan=plan, checkpoint_dir=ck)
    assert part1.preempted and part1.checkpoint is not None
    assert part1.ticks == latest_step(ck) == 5
    assert part1.stats["faults"]["preempts"] == 1
    assert set(part1.outputs) < {r.rid for r in reqs}
    saved = eng.last_pools
    tr1 = eng.scheduler_stream().materialize()
    like = {"pools": saved,
            "lane_tok": torch.zeros((4, 1), dtype=torch.int32)}
    back = restore_checkpoint(ck, 5, like)
    for key, pair in saved.items():
        for h in ("k", "v"):
            assert torch.equal(back["pools"][key][h], pair[h])
    manifest = json.loads((Path(part1.checkpoint) /
                           "manifest.json").read_text())
    assert manifest["paths"][0] == "['lane_tok']"
    assert manifest["shapes"][0] == [4, 1]
    assert manifest["dtypes"][0] == "int32"
    part2 = eng.run_scheduler(None, fault_plan=plan, resume_from=ck)
    assert not part2.preempted and part2.checkpoint is None
    assert sorted(part2.outputs) == sorted(baseline)
    for r in reqs:
        np.testing.assert_array_equal(part2.outputs[r.rid], baseline[r.rid])
    tr2 = eng.scheduler_stream().materialize()
    _halves_equal_the_full_day(eng, reqs, plan, tr1, tr2)


def test_guard_tripped_day_checkpoints_and_resumes(eng, baseline, tmp_path):
    """A real ``PreemptionGuard`` whose SIGTERM arrives before the run: the
    day checkpoints after its first tick, and the resumed half finishes it
    with the uninterrupted tokens; the halves' traces are the full day's."""
    import signal
    reqs = _requests(PS)
    ck = str(tmp_path / "ck")
    with PR.PreemptionGuard(signals=(signal.SIGTERM,)) as guard:
        signal.raise_signal(signal.SIGTERM)
        assert guard.should_stop
        part1 = eng.run_scheduler(reqs, guard=guard, checkpoint_dir=ck)
    assert part1.preempted and part1.ticks == 1
    assert part1.stats["faults"]["preempts"] == 0
    tr1 = eng.scheduler_stream().materialize()
    part2 = eng.run_scheduler(None, resume_from=ck)
    assert not part2.preempted
    for r in reqs:
        np.testing.assert_array_equal(part2.outputs[r.rid], baseline[r.rid])
    _halves_equal_the_full_day(eng, reqs, None, tr1,
                               eng.scheduler_stream().materialize())


def test_preempted_chaos_day_resumes_between_its_faults(eng, baseline,
                                                        tmp_path):
    """The chaos day preempted after its bank loss and before its page
    corruption and transient: the resumed half recovers the page, retries
    the step and finishes with the healthy day's tokens; its fault
    counters add up to the uninterrupted chaos day's."""
    reqs = _requests(PS)
    plan = PR.FaultPlan(tuple(sorted(
        tuple(P_CHAOS) + (PR.FaultEvent(tick=4, kind="preempt"),),
        key=lambda e: e.tick)))
    ck = str(tmp_path / "ck")
    part1 = eng.run_scheduler(reqs, fault_plan=plan, checkpoint_dir=ck)
    assert part1.preempted
    tr1 = eng.scheduler_stream().materialize()
    part2 = eng.run_scheduler(None, fault_plan=plan, resume_from=ck)
    for r in reqs:
        np.testing.assert_array_equal(part2.outputs[r.rid], baseline[r.rid])
    f = part2.stats["faults"]
    assert (f["dead_banks"], f["recoveries"], f["transients"],
            f["preempts"]) == ([1], 1, 2, 1)
    _halves_equal_the_full_day(eng, reqs, plan, tr1,
                               eng.scheduler_stream().materialize())


def test_preemption_cross_resumes_between_the_port_and_the_reference(
        eng, r_eng, tmp_path):
    """A day preempted by the reference engine resumes in the port, and one
    preempted by the port resumes in the reference: both end with the
    reference's uninterrupted outputs, and the resumed halves record the
    same trace."""
    want = r_eng.run_scheduler(_requests(RS)).outputs
    r_ck, p_ck = str(tmp_path / "r"), str(tmp_path / "p")
    r1 = r_eng.run_scheduler(_requests(RS), fault_plan=_preempt_plan(RR, 4),
                             checkpoint_dir=r_ck)
    p1 = eng.run_scheduler(_requests(PS), fault_plan=_preempt_plan(PR, 4),
                           checkpoint_dir=p_ck)
    assert r1.preempted and p1.preempted and r1.ticks == p1.ticks
    for name in ("manifest.json", "aux.json"):
        assert (json.loads((Path(r1.checkpoint) / name).read_text())
                == json.loads((Path(p1.checkpoint) / name).read_text()))
    got = eng.run_scheduler(None, fault_plan=_preempt_plan(PR, 4),
                            resume_from=r_ck)
    p_tr = eng.scheduler_stream().materialize()
    back = r_eng.run_scheduler(None, fault_plan=_preempt_plan(RR, 4),
                               resume_from=p_ck)
    r_tr = r_eng.scheduler_stream().materialize()
    for res in (got, back):
        assert not res.preempted and sorted(res.outputs) == sorted(want)
        for rid, toks in want.items():
            np.testing.assert_array_equal(res.outputs[rid], toks)
    _traces_equal(p_tr, r_tr)


# -- the serve CLI -----------------------------------------------------------

def test_serve_fault_cli_prints_the_references_lines(capsys):
    """``serve --schedule --fault-bank 1 --fault-tick 4 --cost``'s
    ``run_schedule`` on the smoke config and the same weights: the tokens,
    the stats line, the fault summary and the cost table with its degraded
    row are the reference CLI's, line for line; ``--fault-bank`` without
    ``--schedule`` is refused."""
    args = argparse.Namespace(
        n_requests=8, arrival_rate=1.5, context_dist="mixed", seed=0,
        policy="seq-skew", cost=True, fault_bank=1, fault_tick=4)
    max_seq = 16 + 32 + 4                 # the CLIs' prompt + new + 4
    p_eng = ServeEngine(CFG, RunConfig(remat="none", attn_impl="dense"),
                        PARAMS, P_NO_AXES,
                        max_batch=4, max_seq=max_seq, device="cpu")
    p_serve_cli.run_schedule(args, p_eng, CFG)
    got = capsys.readouterr().out
    r_eng = RServe(RCFG, RRun(remat="none", attn_impl="dense"), R_PARAMS,
                   NO_AXES, max_batch=4, max_seq=max_seq)
    r_serve_cli.run_schedule(args, r_eng, RCFG)
    want = capsys.readouterr().out
    assert got == want
    lines = got.splitlines()
    assert any(ln.startswith("faults: bank(s) [1] lost at tick 4")
               for ln in lines)
    assert lines[-1].startswith("16B!d1") and lines[-1].endswith(
        "(degraded survivors)")
    with pytest.raises(SystemExit):
        p_serve_cli.main(["--smoke", "--device", "cpu", "--fault-bank", "1"])
    assert "--fault-bank needs --schedule" in capsys.readouterr().err
