"""The port's autotuner (``repro_torch.tune``), its benchmark
(``repro_torch.bench.autotune``) and its quickstart held to the JAX package
on the CPU: ``search`` ranks every point as ``repro.tune.search`` does
(arch, total cycles, time and objective, point for point) on the paper's
transposes and FFT, the smoke serving traffic, a hot-row ``banked_gather``
kernel trace and the area × time objective at 224 KB, with both
strategies; the search space's lattice equals the reference's; the
autotune ``--smoke`` rows and the quickstart's output equal the
reference's; and the six paper winners are pinned on the port alone."""
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import autotune as RAUTO  # noqa: E402
from repro import bench as RB  # noqa: E402
from repro import tune as RT  # noqa: E402
from repro_torch import tune as PT  # noqa: E402
from repro_torch.bench import autotune as PAUTO  # noqa: E402
from repro_torch.bench import workloads as PW  # noqa: E402
from repro_torch.examples import autotune_quickstart as PQ  # noqa: E402

HOT_TABLE = np.zeros((256, 64), np.float32)
HOT_IDX = np.zeros(512, np.int64)          # every lane hits row 0


def _space(mod, name):
    return {"paper": mod.PAPER_SPACE, "extended": mod.EXTENDED_SPACE,
            "transpose": mod.ArchSpace(multiports=("4R-1W", "4R-2W"))}[name]


def _case(case, pkg):
    """(kernel, workload, space name, objective kwargs) of one case, built
    from the reference (``pkg == "ref"``) or the port (on the CPU)."""
    ref = pkg == "ref"
    b = RB if ref else PW
    dev = {} if ref else {"device": "cpu"}
    if case == "transpose32":
        return None, b.transpose_workload(32), "transpose", {}
    if case == "transpose64":
        return None, b.transpose_workload(64), "transpose", {}
    if case == "transpose32_extended":
        return None, b.transpose_workload(32), "extended", {}
    if case == "fft4096r16":
        return None, b.fft_workload(4096, 16), "paper", {}
    if case == "serve_smoke":
        return None, b.serving_workload(batch=4, prompt_len=16,
                                        decode_steps=8, page_len=4,
                                        n_kv_layers=2, **dev), "paper", {}
    if case == "hot_gather":
        return "banked_gather", (HOT_TABLE, HOT_IDX), "extended", {}
    if case == "area_time_224kb":
        return (None, b.fft_workload(4096, 16), "paper",
                {"objective": "area_time", "capacity_kb": 224.0})
    raise KeyError(case)


def _ranking(results):
    return [(r.arch, r.total_cycles, r.time_us, r.objective)
            for r in results]


CASES = ["transpose32", "transpose64", "transpose32_extended", "fft4096r16",
         "serve_smoke", "hot_gather", "area_time_224kb"]


@pytest.mark.parametrize("strategy", ["exhaustive", "hillclimb"])
@pytest.mark.parametrize("case", CASES)
def test_search_ranks_as_the_reference(case, strategy):
    rk, rw, rs, rkw = _case(case, "ref")
    pk, pw, ps, pkw = _case(case, "port")
    want = RT.search(rk, rw, space=_space(RT, rs), strategy=strategy, **rkw)
    got = PT.search(pk, pw, space=_space(PT, ps), strategy=strategy,
                    device="cpu", **pkw)
    assert _ranking(got) == _ranking(want)
    assert [r.record for r in got] == [r.record for r in want]


def test_area_time_rules_out_over_capacity_multiports():
    ranked = PT.search(workload=PW.fft_workload(4096, 16),
                       objective="area_time", capacity_kb=224.0,
                       device="cpu")
    scores = {r.arch: r.objective for r in ranked}
    assert scores["4R-1W"] == scores["4R-1W-VB"] == float("inf")
    assert ranked[0].arch == "4B-offset"


def test_callable_and_cycles_objectives_equal_the_reference():
    def fn(rec, a):
        return rec["total_cycles"] * (2 if a.is_banked else 1)
    for objective in (fn, "cycles"):
        want = RT.search(workload=RB.transpose_workload(64),
                         objective=objective)
        got = PT.search(workload=PW.transpose_workload(64),
                        objective=objective, device="cpu")
        assert _ranking(got) == _ranking(want)
    assert got[0].arch == "4R-2W" and got[0].objective == 3463


def test_search_refuses_what_the_reference_refuses():
    w = PW.transpose_workload(32)
    for kw in ({"workload": w, "strategy": "anneal"},
               {"workload": (1, 2)},
               {"workload": w, "objective": "area_time"},
               {"workload": w, "objective": "bytes"},
               {"workload": w, "objective": "us_per_token"}):
        with pytest.raises(ValueError):
            PT.search(device="cpu", **kw)
        ref_kw = dict(kw, workload=RB.transpose_workload(32)
                      if kw["workload"] is w else kw["workload"])
        with pytest.raises(ValueError):
            RT.search(**ref_kw)
    with pytest.raises(ValueError, match="n_tokens"):
        PT.search(workload=w, objective="us_per_token", device="cpu")
    top2 = PT.search(workload=w, space=_space(PT, "transpose"), top_k=2,
                     device="cpu")
    assert [r.arch for r in top2] == ["4R-2W", "16B-offset"]


# ----------------------------------------------------- the search space --

@pytest.mark.parametrize("space", ["paper", "extended", "transpose"])
def test_space_lattice_equals_the_reference(space):
    ref, port = _space(RT, space), _space(PT, space)
    assert port.names() == ref.names()
    assert port.start_point() == ref.start_point()
    for p in ref.banked_points():
        assert port.neighbors(p) == ref.neighbors(p)


@settings(deadline=None, database=None, max_examples=60)
@given(banks=st.lists(st.sampled_from([2, 4, 8, 16, 32, 64]), min_size=1,
                      max_size=4, unique=True),
       mappings=st.lists(st.sampled_from(["lsb", "offset", "xor", "fold"]),
                         min_size=1, max_size=4, unique=True),
       broadcast=st.lists(st.booleans(), min_size=1, max_size=2,
                          unique=True),
       shifts=st.lists(st.integers(1, 4), min_size=1, max_size=3,
                       unique=True))
def test_property_spaces_equal_the_reference(banks, mappings, broadcast,
                                             shifts):
    kw = dict(banks=tuple(banks), mappings=tuple(mappings),
              broadcast=tuple(broadcast), map_shifts=tuple(shifts))
    ref, port = RT.ArchSpace(**kw), PT.ArchSpace(**kw)
    assert port.names() == ref.names()
    assert port.start_point() == ref.start_point()
    for p in ref.banked_points():
        assert port.neighbors(p) == ref.neighbors(p)
    for name in port.names():
        from repro_torch.core import arch as PA
        assert PA.get(name).name == name           # names round-trip


# ------------------------------------------ the paper winners, port only --

#: the six paper per-workload winners (Tables II/III best wall time)
PAPER_WINNERS = [(("transpose", 32), "4R-2W"), (("transpose", 64), "4R-2W"),
                 (("transpose", 128), "4R-2W"), (("fft", 4), "16B-offset"),
                 (("fft", 8), "16B-offset"), (("fft", 16), "4R-1W-VB")]


@pytest.mark.parametrize("workload,winner", PAPER_WINNERS)
def test_port_finds_the_paper_winners(workload, winner):
    kind, n = workload
    w = (PW.transpose_workload(n) if kind == "transpose"
         else PW.fft_workload(4096, n))
    space = _space(PT, "transpose" if kind == "transpose" else "paper")
    for strategy in ("exhaustive", "hillclimb"):
        ranked = PT.search(workload=w, space=space, strategy=strategy,
                           device="cpu")
        assert ranked[0].arch == winner
    assert len(PT.search(workload=w, space=space, device="cpu")) == len(
        space.names())


def test_port_pins_the_shifted_offset_finding():
    ranked = PT.search(workload=PW.fft_workload(4096, 4),
                       space=PT.ArchSpace(map_shifts=(1, 2)), device="cpu")
    by_arch = {r.arch: r.total_cycles for r in ranked}
    assert by_arch["16B-offset-s2"] < by_arch["16B-offset"]
    assert ranked[0].arch == "16B-offset-s2"


def test_hillclimb_agrees_with_exhaustive_at_fewer_evals():
    w = PW.transpose_workload(32)
    full = PT.search(workload=w, space=PT.EXTENDED_SPACE, device="cpu")
    climbed = PT.search(workload=w, space=PT.EXTENDED_SPACE,
                        strategy="hillclimb", device="cpu")
    assert climbed[0].arch == full[0].arch
    assert len(climbed) < len(PT.EXTENDED_SPACE.names())


# --------------------------------------- the benchmark and the quickstart --

def test_autotune_cases_equal_the_reference():
    got = [(w.name, s, pick) for w, s, pick in PAUTO._cases(False, "cpu")]
    want = [(w.name, s, pick) for w, s, pick in RAUTO._cases(False)]
    assert [(n, pick) for n, _, pick in got] == [(n, pick)
                                                 for n, _, pick in want]
    for (_, ps, _), (_, rs, _) in zip(got, want):
        assert ps.names() == rs.names()
    assert [pick for _, _, pick in got] == [
        "4R-2W", "4R-2W", "4R-2W", "4R-2W", "16B-offset", "16B-offset",
        "4R-1W-VB", "4R-1W"]


def test_autotune_smoke_rows_equal_the_reference(capsys):
    got = PAUTO.main(["--smoke", "--device", "cpu"])
    assert got == RAUTO.rows(smoke=True)
    assert len(got) == 4 and all(r["match"] for r in got)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("autotune_transpose32_exhaustive,1.93,winner=4R-2W|"
                        "paper_winner=4R-2W|match=True|total_cycles=1159|"
                        "evals=8")
    assert len(lines) == 4


def test_quickstart_prints_what_the_reference_prints(capsys):
    runpy.run_path(str(ROOT / "examples" / "autotune_quickstart.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    got = PQ.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert got == {"transpose64": "4R-2W",
                   "fft4096r4_hillclimb": ("32B-fold-bcast", 20),
                   "hot_gather": "4B-bcast",
                   "area_time_224kb": "4B-offset"}


def test_entry_points_default_to_the_card():
    import inspect
    assert inspect.signature(PT.search).parameters["device"].default == \
        "cuda"
    assert inspect.signature(PAUTO.rows).parameters["device"].default == \
        "cuda"
    if not torch.cuda.is_available():
        for main in (PAUTO.main, PQ.main):
            with pytest.raises(SystemExit, match="no CUDA device"):
                main([])
