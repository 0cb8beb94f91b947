"""The port's area model and its sweeps held to the JAX package on the CPU:
``repro_torch.core.cost`` (Table I verbatim, resources, replication,
capacities, footprints, the area × time score) equals ``repro.core.cost``
on every paper memory and on 32 / 64 banks at 16–448 KB, raising where
the reference raises; the architecture hooks, ``TRANSPOSE_MEMORIES`` and
``configs.paper_simt`` equal the reference's; and the rows of Table I,
Fig 9, the bank-scaling sweep and the beyond-paper sweep equal the
reference scripts' ``rows()`` with ``==``."""
import dataclasses
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import bank_scaling as RBS  # noqa: E402
from benchmarks import beyond_paper as RBP  # noqa: E402
from benchmarks import fig9_cost_perf as RF9  # noqa: E402
from benchmarks import table1_area as RT1  # noqa: E402
from repro.configs import paper_simt as RSIMT  # noqa: E402
from repro.core import arch as RA  # noqa: E402
from repro.core import cost as RC  # noqa: E402
from repro.core import memsim as RM  # noqa: E402
from repro_torch.bench import bank_scaling as PBS  # noqa: E402
from repro_torch.bench import beyond_paper as PBP  # noqa: E402
from repro_torch.bench import paper_tables as PT  # noqa: E402
from repro_torch.configs import paper_simt as PSIMT  # noqa: E402
from repro_torch.core import arch as PA  # noqa: E402
from repro_torch.core import cost as PC  # noqa: E402
from repro_torch.core import memsim as PM  # noqa: E402

#: every paper memory, and the banked counts beyond Table I (its rows stop
#: at 16 banks, so resources and the processor footprint raise there)
SPEC_NAMES = [s.name for s in PM.PAPER_MEMORIES] + ["32B", "64B", "32B-xor"]
CAPACITIES = (16.0, 32.0, 64.0, 100.0, 112.0, 112.5, 168.0, 224.0, 224.5,
              300.0, 448.0, 448.5)


def _specs(name):
    """(reference MemSpec, port MemSpec) of one architecture name."""
    return RA.get(name).spec, PA.get(name).spec


def _outcome(fn, *args):
    """What a call gives: its value (a ``Resources`` as a tuple), or the
    type of the exception it raises."""
    try:
        got = fn(*args)
    except (ValueError, KeyError) as e:
        return ("raises", type(e).__name__)
    return dataclasses.astuple(got) if dataclasses.is_dataclass(got) else got


def test_constants_and_table1_equal_the_reference():
    for k in ("SECTOR_ALMS", "SECTOR_M20KS", "M20K_KBYTES", "MAX_BANKED_KB",
              "TABLE_I"):
        assert getattr(PC, k) == getattr(RC, k), k
    assert (dataclasses.astuple(PC.core_resources())
            == dataclasses.astuple(RC.core_resources()))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_area_model_equals_the_reference(name):
    """Every function of the model on one memory at every capacity, with
    the reference's ValueError above a multi-port's cap (and its KeyError
    where Table I has no row)."""
    ref, port = _specs(name)
    for fn in ("memory_resources", "replication_factor", "max_capacity_kb"):
        assert (_outcome(getattr(PC, fn), port)
                == _outcome(getattr(RC, fn), ref)), fn
    for cap in CAPACITIES:
        for fn in ("footprint_alms", "processor_footprint_alms",
                   "pipelining_alms"):
            arg = ((port, cap), (ref, cap))
            if fn == "pipelining_alms":
                arg = ((cap,), (cap,))
            assert (_outcome(getattr(PC, fn), *arg[0])
                    == _outcome(getattr(RC, fn), *arg[1])), (fn, cap)
        assert (_outcome(PC.area_time_score, port, cap, 12.5)
                == _outcome(RC.area_time_score, ref, cap, 12.5)), cap


def test_multiport_caps_raise_as_the_reference():
    for name, cap in (("4R-1W", 112.0), ("4R-1W-VB", 112.0),
                      ("4R-2W", 224.0)):
        ref, port = _specs(name)
        assert PC.max_capacity_kb(port) == RC.max_capacity_kb(ref) == cap
        assert PC.footprint_alms(port, cap) == RC.footprint_alms(ref, cap)
        for mod, spec in ((PC, port), (RC, ref)):
            with pytest.raises(ValueError, match="caps at"):
                mod.footprint_alms(spec, cap + 0.5)
            assert mod.area_time_score(spec, cap + 0.5, 1.0) == float("inf")
    ref, port = _specs("16B")
    for mod, spec in ((PC, port), (RC, ref)):
        with pytest.raises(ValueError, match="caps at"):
            mod.footprint_alms(spec, 448.5)


@settings(deadline=None, database=None, max_examples=60)
@given(name=st.sampled_from(SPEC_NAMES),
       cap=st.floats(min_value=0.0, max_value=600.0, allow_nan=False),
       time_us=st.floats(min_value=0.0, max_value=1e4, allow_nan=False))
def test_property_footprints_equal_the_reference(name, cap, time_us):
    ref, port = _specs(name)
    assert (_outcome(PC.footprint_alms, port, cap)
            == _outcome(RC.footprint_alms, ref, cap))
    assert (_outcome(PC.processor_footprint_alms, port, cap)
            == _outcome(RC.processor_footprint_alms, ref, cap))
    assert (_outcome(PC.area_time_score, port, cap, time_us)
            == _outcome(RC.area_time_score, ref, cap, time_us))


@pytest.mark.parametrize("name", SPEC_NAMES + ["16B-bcast", "12B", "6B-offset",
                                               "8R-1W"])
def test_arch_hooks_equal_the_reference(name):
    ref, port = RA.get(name), PA.get(name)
    assert (_outcome(port.resources) == _outcome(ref.resources))
    for cap in (64.0, 112.0, 224.0, 448.0, 500.0):
        assert (_outcome(port.footprint_alms, cap)
                == _outcome(ref.footprint_alms, cap))
        assert (_outcome(port.processor_footprint_alms, cap)
                == _outcome(ref.processor_footprint_alms, cap))
    for cycles in (0, 1159, 42394, 10 ** 9):
        assert port.time_us(cycles) == ref.time_us(cycles)
    if ref.is_banked:
        assert port.total_banks == ref.total_banks


def test_transpose_memories_and_simt_config_equal_the_reference():
    assert ([m.name for m in PM.TRANSPOSE_MEMORIES]
            == [m.name for m in RM.TRANSPOSE_MEMORIES])
    assert ([m.name for m in PSIMT.MEMORY_VARIANTS]
            == [m.name for m in RSIMT.MEMORY_VARIANTS])
    for f in dataclasses.fields(RSIMT.SimtConfig):
        want, got = getattr(RSIMT.CONFIG, f.name), getattr(PSIMT.CONFIG,
                                                          f.name)
        if f.name == "shared_memory":
            want, got = want.name, got.name
        assert got == want, f.name
    from repro_torch import core
    assert core.TRANSPOSE_MEMORIES is PM.TRANSPOSE_MEMORIES
    assert core.cost is PC


# ----------------------------------------------------- the rows, with == --

def test_table1_rows_equal_the_reference():
    got = PT.table1_rows()
    assert got == RT1.rows()
    t1 = {r["name"]: r for r in got}
    assert t1["mem_16B"]["footprint_max"] == 16640          # 1 sector
    assert t1["mem_4R-1W"]["max_capacity_kb"] == 112.0


def test_fig9_rows_equal_the_reference():
    got = PT.fig9_rows("cpu")
    assert got == RF9.rows()
    assert len(got) == 24
    over = {r["name"] for r in got if r["footprint_alms"] == "over-capacity"}
    assert over == {"fig9_168KB_4R-1W", "fig9_224KB_4R-1W"}
    b16 = {r["footprint_alms"] for r in got if r["name"].endswith("_16B")}
    assert b16 == {26049}


def test_bank_scaling_rows_equal_the_reference():
    got = PBS.rows("cpu")
    assert got == RBS.rows()
    assert len(got) == 10
    # the reference's claims (tests/test_bank_scaling.py) on the port's rows
    r = {x["name"]: x for x in got}
    assert (r["bankscale_fft_r16_16B_xor"]["us_per_call"]
            < r["bankscale_fft_r16_64B_offset"]["us_per_call"])


def test_beyond_paper_rows_equal_the_reference():
    assert PBP.PAPER_BEST == RBP.PAPER_BEST
    got = PBP.rows("cpu")
    assert got == RBP.rows()
    assert len(got) == 20
    r = {x["name"]: x for x in got}
    assert r["beyond_fft r16_16B-xor"]["vs_paper_best_any_pct"] < -25


@pytest.mark.parametrize("name", ["32B-xor", "64B-offset", "16B-xor-bcast",
                                  "16B-offset-bcast", "64B-xor", "4B-xor"])
def test_sweep_names_resolve_to_the_reference_spec(name):
    ref, port = _specs(name)
    for f in dataclasses.fields(PM.MemSpec):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("name", ["4x4B-g64", "2x8B-g32", "4x3B",
                                  "16B!d3", "16B-offset!d0+5"])
def test_two_level_and_degraded_names_stay_refused(name):
    """The two-level and the degraded (bank-offline) names resolve to the
    reference's spec and area, field for field (``dead_banks`` included);
    a degraded name keeps its healthy base's layout and is never
    registered.  (The degraded names were refused until the port had
    them; the name of the test is kept.)"""
    ref = RA.get(name)                 # the reference has them all
    port = PA.get(name)
    for f in dataclasses.fields(PM.MemSpec):
        assert getattr(port.spec, f.name) == getattr(ref.spec, f.name), f.name
    assert [f.name for f in dataclasses.fields(PM.MemSpec)] == [
        f.name for f in dataclasses.fields(RM.MemSpec)]
    assert port.total_banks == ref.total_banks
    if "!d" in name:
        assert name not in PA.names() and name not in RA.names()
        assert port.dead_banks == ref.dead_banks
        assert ((port.layout.n_banks, port.layout.mapping,
                 port.layout.shift) == (ref.layout.n_banks,
                                        ref.layout.mapping,
                                        ref.layout.shift))
    else:
        assert port.layout is None and ref.layout is None
    # "4x3B" has no Table I row: both raise the same KeyError
    assert _outcome(port.resources) == _outcome(ref.resources)
    for kb in (16, 64, 224):
        assert (_outcome(port.footprint_alms, kb)
                == _outcome(ref.footprint_alms, kb))
        assert (_outcome(port.processor_footprint_alms, kb)
                == _outcome(ref.processor_footprint_alms, kb))


@pytest.mark.parametrize("cli", ["table1", "fig9"])
def test_paper_tables_sections_print_the_reference_lines(cli, capsys):
    rows = PT.main([cli, "--device", "cpu"])[cli]
    lines = capsys.readouterr().out.splitlines()
    want = RT1.rows() if cli == "table1" else RF9.rows()
    assert rows == want
    assert lines == [PT.format_fields(r) for r in want]
    assert lines[0].startswith("simt_core_16sp,0,alms=7113|"
                               if cli == "table1" else "fig9_64KB_4R-1W,")


def test_sweep_clis_print_their_rows(capsys):
    assert PBS.main(["--device", "cpu"]) == RBS.rows()
    assert PBP.main(["--device", "cpu"]) == RBP.rows()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 30
    assert lines[0].startswith("bankscale_fft_r16_4B_offset,70.51,")
