"""The port's online tuner (repro_torch.tune.online) held to the JAX
reference's (repro.tune.online): a counterpart of every case of
``tests/test_tune_online.py``, each comparing the port's rows and
recommendations with the reference tuner's on the same traces, plus two
live cases: the step traces of a smoke ``ServeEngine`` generation fed to
both tuners give equal ``recommend()`` dicts at every step, and a tuner
bound to the port's engine steps through ``engine.step_trace()``.

Cycles, op counts and cache counters are integers and are compared
exactly; the ``time_us`` objective's floats are the same float64
arithmetic on the same integers, so they are compared exactly too.  The
port prices on the host here (``device="cpu"``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.cost_engine import BlockCostCache as RCache
from repro.core.trace import AddressTrace as RTrace
from repro.core.trace import TraceStream as RStream
from repro.tune import OnlineTuner as ROnline
from repro.tune import online as r_online
from repro_torch.core import arch
from repro_torch.core.cost_engine import BlockCostCache, cost_many
from repro_torch.core.trace import AddressTrace, TraceStream
from repro_torch.tune import OnlineTuner, online

ARCHS = ("16B", "16B-offset", "8B", "4B", "12B", "4x4B-g64", "4R-2W")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's host work on one thread (see
    ``_torch_train_parity.one_torch_thread``): the smoke models run many
    small ops, and under parallel test workers a thread pool per worker
    waits at every op for cores the other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _addrs(i, n_ops=24, stride=1):
    return ((np.arange(n_ops * 16, dtype=np.int64) * stride + 7 * i)
            % 2039).reshape(n_ops, 16).astype(np.int32)


def _step_trace(i, n_ops=24, stride=1, cls=AddressTrace):
    """One synthetic decode step of traffic (the reference test's)."""
    return cls.from_ops(_addrs(i, n_ops, stride),
                        kind="load" if i % 3 else "store")


def _ref_step(i, n_ops=24, stride=1):
    return _step_trace(i, n_ops, stride, cls=RTrace)


def _rows(rows):
    return [(n, v, dataclasses.asdict(c)) for n, v, c in rows]


def _tuners(archs=ARCHS, **kw):
    return (OnlineTuner(archs, device="cpu", **kw),
            ROnline(archs, **kw))


# ------------------------------------------------ incremental == rebuild --

def test_incremental_reprice_bit_equal_to_full_rebuild():
    tuner, ref = _tuners(window=6)
    for i in range(10):
        tuner.observe(_step_trace(i))
        ref.observe(_ref_step(i))
        inc = tuner.reprice()
        full = tuner.reprice(full_rebuild=True)
        assert inc == full, f"step {i}"
        assert _rows(inc) == _rows(ref.reprice()), f"step {i}"
    assert tuner.cache.stats["hits"] > 0
    assert tuner.cache.stats == ref.cache.stats


def test_reprice_matches_offline_cost_many_on_window():
    tuner, ref = _tuners(window=4)
    traces = [_step_trace(i) for i in range(7)]
    for i, t in enumerate(traces):
        tuner.observe(t)
        ref.observe(_ref_step(i))
    rows = tuner.reprice()
    archs = [arch.get(n) for n in ARCHS]
    want = cost_many(archs, TraceStream(traces[-4:]), device="cpu")
    by_name = {a.name: c for a, c in zip(archs, want)}
    assert {n: c for n, _, c in rows} == by_name
    assert [r[1] for r in rows] == sorted(r[1] for r in rows)
    assert _rows(rows) == _rows(ref.reprice())


def test_window_eviction_only_last_w_steps_priced():
    tuner, ref = _tuners(("16B",), window=2)
    for t, r in ((_step_trace(0, n_ops=64), _ref_step(0, n_ops=64)),
                 (_step_trace(1, n_ops=1), _ref_step(1, n_ops=1)),
                 (_step_trace(2, n_ops=1), _ref_step(2, n_ops=1))):
        tuner.observe(t)
        ref.observe(r)
    (_, _, cost), = tuner.reprice()
    small = [_step_trace(1, n_ops=1), _step_trace(2, n_ops=1)]
    assert cost == cost_many([arch.get("16B")], TraceStream(small),
                             device="cpu")[0]
    assert _rows([(0, 0, cost)]) == _rows([(0, 0, ref.reprice()[0][2])])


def test_observe_accepts_streams():
    tuner, ref = _tuners(("16B",), window=3)
    parts = [_step_trace(0), _step_trace(1)]
    tuner.observe(TraceStream(parts))
    ref.observe(RStream([_ref_step(0), _ref_step(1)]))
    (_, _, cost), = tuner.reprice()
    assert cost == cost_many([arch.get("16B")], AddressTrace.concat(*parts),
                             device="cpu")[0]
    assert _rows(tuner.reprice()) == _rows(ref.reprice())


# ----------------------------------------------------------- hysteresis --

def _forced(patience=2, margin=0.0):
    kw = dict(window=4, current="16B", patience=patience, margin=margin)
    return _tuners(("16B", "16B-offset"), **kw)


def _recommend_both(tuner, ref, i, stride=2):
    tuner.observe(_step_trace(i, stride=stride))
    ref.observe(_ref_step(i, stride=stride))
    got, want = tuner.recommend(), ref.recommend()
    assert got == want
    return got


def test_swap_requires_patience_consecutive_wins():
    tuner, ref = _forced(patience=3)
    recs = [_recommend_both(tuner, ref, i) for i in range(3)]
    assert recs[0]["winner"] == "16B-offset"
    assert [r["swap"] for r in recs] == [False, False, True]
    assert [r["streak"] for r in recs] == [1, 2, 3]


def test_margin_blocks_marginal_wins():
    tuner, ref = _forced(patience=1, margin=0.99)
    rec = _recommend_both(tuner, ref, 0)
    assert rec["winner"] == "16B-offset" and not rec["swap"]
    assert rec["streak"] == 0


def test_swap_resets_hysteresis_and_rebinds_current():
    tuner, ref = _forced(patience=1)
    rec = _recommend_both(tuner, ref, 0)
    assert rec["swap"]
    tuner.swap(rec["winner"])
    ref.swap(rec["winner"])
    assert tuner.current == "16B-offset"
    rec2 = tuner.recommend()
    assert rec2 == ref.recommend()
    assert rec2["current"] == "16B-offset" and not rec2["swap"]


@pytest.mark.parametrize("objective", ["cycles", "time_us"])
def test_objectives_rank_as_the_reference(objective):
    tuner, ref = _tuners(window=3, objective=objective)
    for i in range(5):
        assert _recommend_both(tuner, ref, i, stride=i + 1)["objective"] == (
            objective)


def test_step_pulls_engine_step_trace():
    class FakeEngine:
        mem_arch = arch.get("16B")

        def __init__(self):
            self.i = 0

        def step_trace(self):
            self.i += 1
            return _step_trace(self.i)

    eng = FakeEngine()
    tuner = online(eng, archs=ARCHS, window=3, device="cpu")
    assert tuner.current == "16B"
    rec = tuner.step()
    assert eng.i == 1 and rec["window_blocks"] == 1
    tuner.step()
    assert rec["ranking"][0][0] == rec["winner"]


def test_online_defaults_to_paper_space():
    from repro_torch.tune.search import PAPER_SPACE
    tuner = online(window=2)
    assert [a.name for a in tuner.archs] == list(PAPER_SPACE.names())
    assert [a.name for a in tuner.archs] == [a.name for a in r_online(
        window=2).archs]
    assert tuner.device == "cuda"
    with pytest.raises(RuntimeError):
        tuner.step()
    with pytest.raises(RuntimeError):
        tuner.reprice()


def test_validation_errors():
    for kw in ({"window": 0}, {"objective": "latency"}):
        with pytest.raises(ValueError):
            ROnline(ARCHS, **kw)
        with pytest.raises(ValueError):
            OnlineTuner(ARCHS, **kw)
    with pytest.raises(ValueError):
        OnlineTuner(())


def test_shared_cache_can_be_injected():
    cache, r_cache = BlockCostCache(max_entries=64), RCache(max_entries=64)
    t1 = OnlineTuner(("16B",), window=2, cache=cache, device="cpu")
    t2 = OnlineTuner(("16B",), window=2, cache=cache, device="cpu")
    r1 = ROnline(("16B",), window=2, cache=r_cache)
    r2 = ROnline(("16B",), window=2, cache=r_cache)
    for t, r in ((t1, r1), (t2, r2)):
        t.observe(_step_trace(0))
        r.observe(_ref_step(0))
        t.reprice()
        r.reprice()
    assert cache.stats["hits"] >= 1
    assert cache.stats == r_cache.stats


def test_repr_equals_the_reference():
    tuner, ref = _tuners(window=5)
    tuner.observe(_step_trace(0))
    ref.observe(_ref_step(0))
    tuner.reprice()
    ref.reprice()
    assert repr(tuner) == repr(ref)


# ------------------------------------------------------- live serving --

def _engines():
    from repro.configs import get_smoke_config as r_smoke
    from repro.configs.base import RunConfig as RRun
    from repro.launch.sharding import NO_AXES
    from repro.models import init_tree as r_init
    from repro.models import model_specs as r_specs
    from repro.serving.engine import ServeEngine as RServe
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.sharding import NO_AXES as P_NO_AXES
    from repro_torch.models import from_jax, model_specs
    from repro_torch.serving.engine import ServeEngine

    cfg, rcfg = get_smoke_config("llama3.2-1b"), r_smoke("llama3.2-1b")
    r_params = r_init(r_specs(rcfg), jax.random.PRNGKey(0))
    params = from_jax(model_specs(cfg), jax.tree.map(np.asarray, r_params),
                      device="cpu")
    kw = dict(max_batch=3, max_seq=32, page_len=8, mem_arch="16B")
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(3, 11)).astype(np.int32)
    eng = ServeEngine(cfg, RunConfig(remat="none", attn_impl="dense",
                                     compute_dtype="float32"), params, P_NO_AXES,
                      device="cpu", **kw)
    ref = RServe(rcfg, RRun(remat="none", attn_impl="dense",
                            compute_dtype="float32"), r_params, NO_AXES,
                 **kw)
    got, want = (e.generate(prompts, max_new_tokens=12) for e in (eng, ref))
    np.testing.assert_array_equal(got.tokens, want.tokens)
    return eng, ref


def test_live_step_traces_recommend_as_the_reference():
    """Each decode step's ``step_trace(i)``, in order, through a tuner over
    the paper lattice (window 4, so the window slides): the port's
    ``recommend()`` dicts equal the reference tuner's at every step, and
    the last step's full rebuild equals its incremental re-price."""
    eng, ref = _engines()
    tuner = online(eng, window=4, device="cpu")
    r_tuner = r_online(ref, window=4)
    n_steps = 11
    for i in range(n_steps):
        assert tuner.step(eng.step_trace(i)) == r_tuner.step(
            ref.step_trace(i)), f"step {i}"
    assert tuner.cache.stats["hits"] > 0
    assert tuner.reprice(full_rebuild=True) == tuner.reprice()


def test_tuner_bound_to_the_engine_steps_through_step_trace():
    eng, _ = _engines()
    tuner = online(eng, window=2, device="cpu")
    assert tuner.current == eng.mem_arch.name == "16B"
    first = tuner.step()
    second = tuner.step()
    assert first["window_blocks"] == 1 and second["window_blocks"] == 2
    # both observations are the engine's last decode step
    last = eng.step_trace()
    want = cost_many(tuner.archs, TraceStream([last, last]), device="cpu")
    assert {n: c for n, _, c in tuner.reprice()} == {
        a.name: c for a, c in zip(tuner.archs, want)}
