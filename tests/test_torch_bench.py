"""The port's benchmark layer (``repro_torch.bench``: the sweep runner, the
workloads, the paper data and the Table II/III CLI) held to the JAX
package on the CPU: the port's ``table2_rows`` / ``table3_rows`` equal the
JAX scripts' ``rows()`` cell for cell (ints equal, the rounded floats
equal), the BENCH_cost.json cycle pins hold, and the reproduction
tolerances of tests/test_benchmarks.py hold on the port's rows."""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import paper_data as RDATA  # noqa: E402
from benchmarks import table2_transpose as RT2  # noqa: E402
from benchmarks import table3_fft as RT3  # noqa: E402
from repro import bench as RB  # noqa: E402
from repro.core import arch as RA  # noqa: E402
from repro_torch import bench as PB  # noqa: E402
from repro_torch.bench import paper_data as PDATA  # noqa: E402
from repro_torch.bench import paper_tables as PT  # noqa: E402
from repro_torch.core import arch as PA  # noqa: E402

_ROWS: dict = {}


def _rows(which):
    """Each table's rows, computed once per process (port on the CPU)."""
    if which not in _ROWS:
        _ROWS[which] = {
            "t2_port": lambda: PT.table2_rows("cpu"),
            "t2_jax": RT2.rows,
            "t3_port": lambda: PT.table3_rows("cpu", verify=False),
            "t3_jax": lambda: RT3.rows(verify=False),
        }[which]()
    return _ROWS[which]


def test_paper_data_equals_the_reference():
    assert PDATA.TABLE2 == RDATA.TABLE2
    assert PDATA.TABLE3 == RDATA.TABLE3
    assert PDATA.COMMON_OPS == RDATA.COMMON_OPS


@pytest.mark.parametrize("table", ["t2", "t3"])
def test_table_rows_equal_the_jax_scripts(table):
    got, want = _rows(f"{table}_port"), _rows(f"{table}_jax")
    assert len(got) == len(want) == (24 if table == "t2" else 27)
    for g, w in zip(got, want):
        assert {k: g[k] for k in w} == w, w["name"]
        for k in w:
            assert type(g[k]) is type(w[k]), (w["name"], k)


def test_table2_kernel_step_is_exact():
    assert all(r["kernel_err"] == 0.0 for r in _rows("t2_port"))


def test_table3_verified_rows_equal_the_jax_script():
    """verify=True: the VM's functional error equals the reference's (the
    same numpy execution), and the kernel transform (the plain version on
    the CPU) agrees with the oracle within 2e-3·max|X|, the tolerance of
    tests/test_kernels.py's full-FFT check."""
    got, want = PT.table3_rows("cpu"), RT3.rows()
    for g, w in zip(got, want):
        assert {k: g[k] for k in w} == w, w["name"]
        assert 0 < g["kernel_err"] <= 2e-3
        assert g["func_rel_err"] <= 2e-3


def test_bench_cost_pins_hold():
    """The 16B cycle pins of BENCH_cost.json: transpose 1613 / 5791 /
    26087 and fft4096r4 64216."""
    pins = {r["workload"]: r["total_cycles_16B"]
            for r in json.loads((ROOT / "BENCH_cost.json").read_text())[
                "results"] if "total_cycles_16B" in r}
    want = {"transpose32": 1613, "transpose64": 5791,
            "transpose128": 26087, "fft4096r4": 64216}
    assert {k: pins[k] for k in want} == want
    rows = {r["name"]: r["total"] for r in _rows("t2_port") + _rows(
        "t3_port")}
    assert {k: rows[f"{k}_16B"] for k in want} == want


def test_reproduction_tolerances_hold_on_the_port():
    """tests/test_benchmarks.py's Table II/III claims on the port's rows:
    Table II within 1.1 % with at least 6 exact cells; Table III within
    5 % (VB rows 8.5 %), 4R-2W radix 16 at the paper's 33.3 % efficiency."""
    t2 = [r for r in _rows("t2_port") if r["delta_pct"] != ""]
    assert len(t2) == 24
    assert max(abs(r["delta_pct"]) for r in t2) <= 1.1
    assert sum(1 for r in t2 if r["delta_pct"] == 0.0) >= 6
    t3 = [r for r in _rows("t3_port") if r["delta_pct"] != ""]
    assert len(t3) == 27
    assert max(abs(r["delta_pct"]) for r in t3
               if "VB" not in r["name"]) <= 5.0
    assert max(abs(r["delta_pct"]) for r in t3 if "VB" in r["name"]) <= 8.5
    r16 = next(r for r in t3 if r["name"] == "fft4096r16_4R-2W")
    assert r16["efficiency_pct"] == pytest.approx(33.3, abs=0.2)


@pytest.mark.parametrize("execute", [False, True])
def test_sweep_records_equal_the_reference(execute):
    archs = ["16B", "8B-offset", "4R-2W", "4R-1W-VB"]
    got = PB.sweep(archs, [PB.transpose_workload(32),
                           PB.fft_workload(64, 4)], execute=execute,
                   device="cpu")
    want = RB.sweep(archs, [RB.transpose_workload(32),
                            RB.fft_workload(64, 4)], execute=execute)
    assert got == want


def test_run_cell_and_verify_workload_equal_the_reference():
    for pw, rw in ((PB.transpose_workload(64), RB.transpose_workload(64)),
                   (PB.fft_workload(256, 16), RB.fft_workload(256, 16))):
        for arch in ("16B-offset", "4R-1W"):
            assert PB.run_cell(arch, pw, device="cpu") == RB.run_cell(arch,
                                                                      rw)
            assert PB.run_cell(arch, pw, execute=True, device="cpu") == (
                RB.run_cell(arch, rw, execute=True))
        assert PB.verify_workload(pw, device="cpu") == RB.verify_workload(rw)
        np.testing.assert_array_equal(pw.init_memory, rw.init_memory)
        assert pw.trace().n_ops == rw.trace().n_ops


def test_serving_workload_cells_equal_the_reference():
    """The trace workload of slice 1, grouped by banked layout, prices the
    same as the reference's on every paper memory."""
    archs = [a.name for a in PA.PAPER_ARCHITECTURES]
    kw = dict(batch=2, prompt_len=8, decode_steps=3, page_len=4)
    got = PB.run_cells(archs, PB.serving_workload(**kw, device="cpu"),
                       device="cpu")
    want = RB.run_cells(archs, RB.serving_workload(**kw))
    assert got == want
    with pytest.raises(ValueError):
        PB.run_cell("16B", PB.serving_workload(**kw, device="cpu"),
                    execute=True, device="cpu")


def test_later_slices_workloads_raise():
    """The workloads of the later slices are ported now and none raises:
    the whole-model workload (with ``models/trace.py``) and the scheduler
    workload (with the scheduler) are the reference's, name, meta and
    lowering key."""
    got = PB.model_workload("llama3_2_1b", device="cpu")
    want = RB.model_workload("llama3_2_1b")
    assert (got.name, got.meta) == (want.name, want.meta)
    for a in ("16B", "8B-offset", "4R-2W"):
        assert got._key(PA.get(a)) == want._key(RA.get(a))
    got, want = PB.scheduler_workload(8), RB.scheduler_workload(8)
    assert (got.name, got.meta) == (want.name, want.meta)


def test_trace_costs_are_the_engines():
    """A cell's record carries the TraceCost of the port's engine."""
    w = PB.transpose_workload(32)
    rec = PB.run_cell("16B", w, device="cpu")
    c = PA.get("16B").cost(w.trace(), device="cpu")
    assert rec["total_cycles"] == c.total_cycles == 1613
    assert dataclasses.asdict(c)["store_cycles"] == rec["store_cycles"]


def test_cli_prints_the_tables(capsys):
    out = PT.main(["table2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert list(out) == ["table2"] and len(lines) == 24
    assert lines[2].startswith("transpose32_16B,2.092,total=1613|paper=1613")
    assert lines[2].endswith("|kernel_err=0.0")
    with pytest.raises(SystemExit):
        PT.main(["table4", "--device", "cpu"])


def test_entry_points_default_to_the_card():
    """The pricing and the kernels run on the card unless the caller asks
    for the CPU; without a card the CLI fails instead of running here."""
    import inspect

    from repro_torch.core.arch import MemoryArchitecture
    from repro_torch.isa import vm
    for fn in (PB.sweep, PB.run_cell, PB.run_cells, PB.verify_workload,
               PB.serving_workload, PT.table2_rows, PT.table3_rows,
               vm.run_program, vm.cost_only, MemoryArchitecture.run_program):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            PT.main(["table2"])
