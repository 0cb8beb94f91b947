"""The port's model-traffic bench (``python -m
repro_torch.bench.model_traffic_bench``) held to
``benchmarks/model_traffic_bench.py`` on the CPU: its grid, kernel points
and pins; the ``--smoke --check`` CLI's rows (llama3_2_1b at its full
published config on the nine paper memories), printed lines and ranking
equal to the reference's ``rows(smoke=True)`` and ``ranking_report(True)``;
the streamed mixtral step's op count, dense matrix and 16B cycles equal to
the reference's gate, with the engine's staging counted in the peak; the
JSON record under ``build/`` or ``--out`` and ``BENCH_cost.json`` left
untouched; the gates failing where a pin breaks."""
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import model_traffic_bench as R  # noqa: E402
from repro_torch.bench import model_traffic_bench as P  # noqa: E402


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_grid_points_and_pins_equal_the_reference():
    assert P.CONFIGS == R.CONFIGS
    assert (P.BATCH, P.PROMPT_LEN, P.PAGE_LEN, P.BLOCK_OPS) == (
        R.BATCH, R.PROMPT_LEN, R.PAGE_LEN, R.BLOCK_OPS)
    assert sorted(P.KERNEL_POINTS) == sorted(R.KERNEL_POINTS)
    for name, args in R.KERNEL_POINTS.items():
        for got, want in zip(P.KERNEL_POINTS[name], args, strict=True):
            np.testing.assert_array_equal(got, want)
    assert (P.PIN_MODEL_WINNER, P.PIN_ATTN_KERNEL_WINNER, P.PIN_FLIPS,
            P.PEAK_HEADROOM) == ("16B", "4R-1W", True, 2.0) == (
        R.PIN_MODEL_WINNER, R.PIN_ATTN_KERNEL_WINNER, R.PIN_FLIPS,
        R.PEAK_HEADROOM)
    assert P.OUT_JSON == ROOT / "build" / "model_traffic_bench.json"


def test_smoke_check_cli_equals_the_reference(tmp_path, capsys):
    """``--smoke --check --device cpu``: the reference's rows, lines and
    ranking, the check passing, the JSON at ``--out`` and
    ``BENCH_cost.json`` unchanged."""
    bench_cost = ROOT / "BENCH_cost.json"
    before = _digest(bench_cost)
    out = tmp_path / "m.json"
    section = P.main(["--smoke", "--check", "--device", "cpu", "--out",
                      str(out)])
    lines = capsys.readouterr().out.splitlines()
    want_rows = R.rows(smoke=True)
    want_rank = R.ranking_report(True)
    assert section["rows"] == want_rows and len(want_rows) == 9
    assert section["ranking"] == want_rank
    assert [c["workload"] for c in section["checks"]] == [
        "check_streamed_step"] and section["checks"][0]["ok"]
    assert want_rank["model_winners"]["llama3.2-1b"]["arch"] == "16B"
    assert want_rank["kernel_winners"]["attn_decode"] == "4R-1W"
    for r, line in zip(want_rows, lines):
        extra = "|".join(f"{k}={v}" for k, v in r.items()
                         if k not in ("name", "us_per_call", "workload",
                                      "arch"))
        assert line == f"{r['name']},{r['us_per_call']},{extra}"
    assert lines[9] == ("# kernel winners attn_decode->4R-1W; "
                        "moe_a2a->4R-2W; ssm_scan->4R-2W; model winners "
                        "llama3.2-1b->16B; llama flips attn_decode winner")
    assert lines[-1].startswith("# check OK")
    record = json.loads(out.read_text())
    assert record["device"] == "cpu" and record["nvidia_smi"] is None
    assert record["model"]["rows"] == want_rows
    assert record["model"]["grid"]["configs"] == list(R.CONFIGS)
    assert _digest(bench_cost) == before


def test_streamed_mixtral_step_equals_the_reference_gate():
    """The ~109k-op step priced through the stream: op count, dense matrix
    and 16B cycles equal to the reference's gate, the host peak (numpy
    plus the engine's staging) at most half the dense matrix."""
    got = P.check_streamed_step("cpu")
    want = R.check_streamed_step()
    for k in ("n_ops", "dense_matrix_bytes", "total_cycles_16B", "model"):
        assert got[k] == want[k], k
    assert got["n_ops"] == 108752
    assert got["pinned_bytes"] > 0
    assert got["ok"] and got["dense_matrix_bytes"] >= P.PEAK_HEADROOM * (
        got["stream_peak_bytes"] + got["pinned_bytes"])


def test_check_fails_where_a_pin_breaks(monkeypatch):
    monkeypatch.setattr(P, "check_streamed_step", lambda device: {
        "ok": False, "stream_peak_bytes": 9, "pinned_bytes": 1,
        "dense_matrix_bytes": 10})
    ranking = {"kernel_winners": {"attn_decode": "16B"},
               "model_winners": {"llama3.2-1b": {"arch": "16B"}},
               "llama_flips_attn_kernel": False}
    _, failures = P.check(ranking, device="cpu")
    assert len(failures) == 3
    assert "attn_decode kernel winner '16B'" in failures[0]
    assert "flip verdict changed" in failures[1]
    assert "streamed mixtral step peaked" in failures[2]


def test_cli_defaults_to_the_card():
    import inspect
    for fn in (P.rows, P.ranking_report, P.check_streamed_step,
               P.workloads):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            P.main(["--smoke"])
