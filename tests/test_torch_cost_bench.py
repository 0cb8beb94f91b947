"""The port's cost-engine benchmark (``repro_torch.bench.cost_bench``) held
to ``benchmarks/cost_bench.py`` on the CPU: the same constants, gates,
cases and row fields; every smoke row bit-equal (loop == batched ==
streamed, pipelined == serial, warm == cold, streamed construction ==
dense) with its 16B cycles equal to the reference engine's on the same
input and to the ``BENCH_cost.json`` pins; the construction peaks seen by
``tracemalloc``; and a CLI that writes only its own JSON.  Speed gates are
the card's to hold and are not asserted here."""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import cost_bench as RCB  # noqa: E402
from repro.core import arch as RA  # noqa: E402
from repro.core import cost_engine as RCE  # noqa: E402
from repro.core.trace import TraceStream as RStream  # noqa: E402
from repro_torch.bench import cost_bench as PCB  # noqa: E402

PINS = {r["workload"]: r for r in json.loads(
    (ROOT / "BENCH_cost.json").read_text())["results"]}
SMOKE = ["transpose32", "serve_b4_p16_d8", "stream_synthetic_serving",
         "pipelined_thunk_stream", "warm_cache_window",
         "construct_transpose256", "construct_transpose1024"]


def _once(fn, device, repeats: int = 5) -> float:
    """One timed call: the rows' values, not their speed, are tested."""
    t0 = time.perf_counter()
    fn()
    return max(time.perf_counter() - t0, 1e-9)


@pytest.fixture(scope="module")
def smoke_rows():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PCB, "_timeit", _once)
        rows = PCB.rows(smoke=True, device="cpu")
    return {r["workload"]: r for r in rows}


def _ref_16b(workload: str) -> int:
    """The reference engine's 16B cycles on the row's own input."""
    a16 = [RA.get("16B")]
    if workload == "transpose32":
        return RCE.cost_many(a16, RCB.transpose_workload(32).trace())[
            0].total_cycles
    if workload == "serve_b4_p16_d8":
        return RCE.cost_many(a16, RCB._serving_trace_16b(4, 16, 8, 4))[
            0].total_cycles
    if workload == "stream_synthetic_serving":
        base = RCB._serving_trace_16b(8, 16, 16, 4)
        return 8 * RCE.cost_many(a16, base)[0].total_cycles
    if workload == "pipelined_thunk_stream":
        blocks = [RCB._synthetic_block(i) for i in range(8)]
        return RCE.cost_many(a16, RStream.from_thunks(
            [lambda b=b: b for b in blocks]))[0].total_cycles
    if workload == "warm_cache_window":
        names = sorted(RA.names())
        blocks = [RCB._synthetic_block(i, n_ops=2048) for i in range(22)]
        costs = RCE.cost_many(names, RStream(blocks[2:]))
        return costs[names.index("16B")].total_cycles
    n = int(workload.removeprefix("construct_transpose"))
    from repro.isa.programs.transpose import transpose_program
    from repro.isa.vm import program_trace
    return RCE.cost_many(a16, program_trace(transpose_program(n)))[
        0].total_cycles


def test_constants_equal_the_reference():
    assert PCB.ARCH_NAMES == RCB.ARCH_NAMES and len(PCB.ARCH_NAMES) == 9
    for k in ("STREAM_BLOCK_OPS", "CHECK_SPEEDUP", "PIPELINE_SPEEDUP",
              "WARM_CACHE_SPEEDUP", "PEAK_FLOOR_BYTES", "OPS_PER_S_FLOORS"):
        assert getattr(PCB, k) == getattr(RCB, k), k


@pytest.mark.parametrize("smoke", [True, False])
def test_cases_equal_the_references(smoke):
    got = list(PCB._cases(smoke, device="cpu"))
    want = list(RCB._cases(smoke))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, p), (_, r) in zip(got, want):
        for f in ("addrs", "kinds", "instr", "mask"):
            g, w = getattr(p, f), getattr(r, f)
            if w is None:
                assert g is None, (name, f)
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}.{f}")
        assert p.compute_cycles == r.compute_cycles


def test_smoke_runs_the_references_rows(smoke_rows):
    assert list(smoke_rows) == SMOKE


@pytest.mark.parametrize("workload", SMOKE)
def test_smoke_row_is_bit_equal_with_the_references_cycles(smoke_rows,
                                                           workload):
    row = smoke_rows[workload]
    # the reference's row fields (BENCH_cost.json), no more and no fewer
    assert set(row) == set(PINS[workload]), workload
    for flag in ("cycles_equal", "prefix_bit_equal", "pipelined_bit_equal",
                 "warm_bit_equal", "construction_bit_equal"):
        assert row.get(flag, True) is True, flag
    assert row["total_cycles_16B"] == _ref_16b(workload)
    if workload != "stream_synthetic_serving":      # the pin is the full run
        assert row["total_cycles_16B"] == PINS[workload]["total_cycles_16B"]
    for k in ("n_ops", "n_archs", "blocks", "window_blocks",
              "shared_blocks", "warm_hits", "dense_matrix_bytes",
              "peak_floor_bytes", "n_blocks", "prefetch"):
        if k in row and workload != "stream_synthetic_serving":
            assert row[k] == PINS[workload][k], k


@pytest.mark.parametrize("n", [256, 1024])
def test_tracemalloc_sees_the_blocks(smoke_rows, n):
    """The construction peaks measure something: a streamed build holds at
    least one numpy block (4096 ops × 16 lanes × 4 B) and stays under its
    gate, and the dense build holds its whole (ops × 16) matrix."""
    row = smoke_rows[f"construct_transpose{n}"]
    assert row["stream_peak_bytes"] >= PCB.STREAM_BLOCK_OPS * 16 * 4
    assert row["stream_peak_bytes"] < max(row["dense_matrix_bytes"],
                                          PCB.PEAK_FLOOR_BYTES)
    assert row["dense_peak_bytes"] >= row["dense_matrix_bytes"]


def _row_cases():
    base = {"workload": "transpose32", "speedup_many": 3.0,
            "cycles_equal": True}
    return [
        [base],
        [{**base, "speedup_many": 1.5}],
        [{**base, "cycles_equal": False}],
        [{"workload": "stream_synthetic_serving", "ops_per_s": 1999,
          "prefix_bit_equal": True}],
        [{"workload": "pipelined_thunk_stream", "speedup_pipelined": 1.9,
          "pipelined_bit_equal": False}],
        [{"workload": "warm_cache_window", "speedup_warm_cache": 4.9,
          "shared_blocks": 18, "window_blocks": 20,
          "warm_bit_equal": True}],
        [{"workload": "construct_transpose256", "peak_gated": True,
          "dense_matrix_bytes": 524288, "stream_peak_bytes": 2097152,
          "peak_floor_bytes": 2097152, "stream_build_ops_per_s": 10,
          "construction_bit_equal": False}],
        [{"workload": "construct_transpose4096", "peak_gated": True,
          "dense_matrix_bytes": 134217728, "stream_peak_bytes": 700000,
          "stream_build_ops_per_s": 10}],
    ]


@pytest.mark.parametrize("results", _row_cases())
def test_check_is_the_references_gate(results):
    assert PCB.check(results) == RCB.check(results)


def test_cli_writes_its_own_json_and_never_bench_cost(smoke_rows, tmp_path,
                                                      monkeypatch, capsys):
    before = (ROOT / "BENCH_cost.json").read_bytes()
    monkeypatch.setattr(PCB, "rows",
                        lambda smoke, device: list(smoke_rows.values()))
    out = tmp_path / "deep" / "cost.json"
    got = PCB.main(["--smoke", "--device", "cpu", "--out", str(out)])
    assert got == list(smoke_rows.values())
    payload = json.loads(out.read_text())
    assert payload["archs"] == list(RCB.ARCH_NAMES)
    assert payload["smoke"] is True and payload["device"] == "cpu"
    assert payload["nvidia_smi"] is None
    assert payload["gates"]["warm_cache_speedup"] == RCB.WARM_CACHE_SPEEDUP
    assert payload["results"] == got
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines[:-1]] == [
        f"cost_{w}" for w in SMOKE]
    assert lines[-1] == f"# wrote {out}"
    assert (ROOT / "BENCH_cost.json").read_bytes() == before
    assert PCB.OUT_JSON.parent.name == "build"


def test_cli_check_fails_on_a_failed_gate(smoke_rows, tmp_path, monkeypatch,
                                          capsys):
    bad = [{**smoke_rows["transpose32"], "speedup_many": 1.0}]
    monkeypatch.setattr(PCB, "rows", lambda smoke, device: bad)
    with pytest.raises(SystemExit) as e:
        PCB.main(["--check", "--device", "cpu", "--out",
                  str(tmp_path / "c.json")])
    assert e.value.code == 1
    assert "CHECK FAILED: transpose32" in capsys.readouterr().err


def test_cli_needs_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(PCB.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        PCB.main(["--smoke"])


def _smi_missing(*a, **k):
    raise FileNotFoundError("nvidia-smi")


def _smi_fails(*a, **k):
    raise subprocess.CalledProcessError(9, a[0])


def _smi_silent(*a, **k):
    return subprocess.CompletedProcess(a[0], 0, stdout="\n", stderr="")


@pytest.mark.parametrize("run,exc", [
    (_smi_missing, FileNotFoundError),
    (_smi_fails, subprocess.CalledProcessError),
    (_smi_silent, RuntimeError)], ids=["missing", "fails", "silent"])
def test_cli_on_the_card_never_writes_a_record_without_nvidia_smi(
        run, exc, tmp_path, monkeypatch):
    """On ``--device cuda`` a failure to read the card's name and power
    limit stops the run before any row is priced or any JSON written."""
    monkeypatch.setattr(PCB.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(PCB.subprocess, "run", run)
    monkeypatch.setattr(PCB, "rows", lambda smoke, device: pytest.fail(
        "priced without the card's name"))
    out = tmp_path / "c.json"
    with pytest.raises(exc):
        PCB.main(["--smoke", "--out", str(out)])
    assert not out.exists()
