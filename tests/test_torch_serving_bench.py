"""The port's serving benchmark (``repro_torch.bench.serving_bench``) and
its two serving examples held to the reference's
(``benchmarks/serving_bench.py``, ``examples/paged_kv_serving.py``,
``examples/serve_lm.py``) on the CPU: the fixed-batch and scheduled rows,
the ranking-flip report, the chaos section and the live check equal the
reference's functions on the same inputs; ``--check`` and ``--chaos
--smoke --check`` pass through ``main``; ``--out`` is written and the
reference's ``BENCH_cost.json`` is left byte for byte as it was; the
examples print what the reference's print, with the same prices and tuner
picks.  The live engines use different weights (the port cannot import
JAX), which the traces and their prices do not depend on."""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import serving_bench as RB  # noqa: E402
from repro import tune as RTune  # noqa: E402
from repro.bench import serving_workload as r_serving_workload  # noqa: E402
from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core import arch as RA  # noqa: E402
from repro.launch.sharding import NO_AXES  # noqa: E402
from repro.models import init_tree as r_init  # noqa: E402
from repro.models import model_specs as r_specs  # noqa: E402
from repro.serving.engine import ServeEngine as RServe  # noqa: E402
from repro_torch.bench import serving_bench as PB  # noqa: E402
from repro_torch.examples import paged_kv_serving, serve_lm  # noqa: E402

BENCH_COST = ROOT / "BENCH_cost.json"
CONSTANTS = ("POINTS", "PAGE_LEN", "N_KV_LAYERS", "SCHED_POINTS",
             "SCHED_N_REQUESTS", "SCHED_LANES", "SCHED_MAX_SEQ",
             "FIXED_POINT", "CHECK_TRAFFIC", "CHECK_N_OPS", "CHECK_CYCLES",
             "DAY_REQUESTS", "DAY_PEAK_HEADROOM", "CHAOS_ARCH",
             "CHAOS_DEAD_BANKS", "CHAOS_CYCLES")


@pytest.fixture(scope="module")
def r_rows():
    return RB.rows(smoke=True)


@pytest.fixture(scope="module")
def r_sched():
    return RB.sched_rows(smoke=True)


def _csv(rows) -> list:
    """The bench's CSV lines of ``rows``, as both ``main``s print them."""
    return [f"{r['name']},{r['us_per_call']},"
            + "|".join(f"{k}={v}" for k, v in r.items()
                       if k not in ("name", "us_per_call", "workload",
                                    "arch"))
            for r in rows]


def test_constants_are_the_references():
    for name in CONSTANTS:
        assert getattr(PB, name) == getattr(RB, name), name


def test_fixed_batch_rows_equal_the_reference(r_rows):
    got = PB.rows(smoke=True, device="cpu")
    assert len(got) == 9 and got == r_rows


def test_sched_rows_and_ranking_flip_equal_the_reference(r_sched):
    got = PB.sched_rows(smoke=True, device="cpu")
    assert len(got) == 18 and got == r_sched
    flips = PB.ranking_flip_report(got, device="cpu")
    assert flips == RB.ranking_flip_report(r_sched)
    assert flips["fixed_batch_winner"] == "4R-2W" and flips["has_flip"]
    assert {v["arch"] for v in flips["day_winners"].values()} == {"4R-1W"}


def test_chaos_section_equals_the_reference():
    got, failures = PB.chaos_section(device="cpu")
    want, r_failures = RB.chaos_section()
    assert got == want and failures == r_failures == []
    assert got["cycles"] == {"healthy": 2800, "faulted": 4660,
                             "faulted_degraded": 4668}
    assert [e.__dict__ for e in PB.chaos_plan()] == [
        e.__dict__ for e in RB.chaos_plan()]


def test_live_check_equals_the_reference():
    got = PB.check_live_equals_sim(device="cpu")
    want = RB.check_live_equals_sim()
    assert {k: got[k] for k in want} == want
    assert want["ok"] and want["n_ops"] == 80
    # the smoke config's 2 KV layers: 7 decode ticks, 6 ingests
    assert got["row_launches"] == {"banked_gather": 14,
                                   "banked_scatter": 26}


def test_main_check_and_chaos_check_pass_and_leave_bench_cost_alone(
        tmp_path, capsys, r_rows, r_sched):
    """``--smoke --check`` and ``--chaos --smoke --check`` through ``main``:
    the reference's CSV lines and gates, both sections in ``--out``, and
    the streamed day's gate counting the engine's staging buffers (which
    ``tracemalloc`` does not see) on the reference's op count."""
    before = BENCH_COST.read_bytes()
    out = tmp_path / "serving_bench.json"
    got = PB.main(["--smoke", "--check", "--device", "cpu", "--out",
                   str(out)])
    text = capsys.readouterr().out
    lines = text.splitlines()
    assert lines[:27] == _csv(r_rows + r_sched)
    assert "# check OK: live==sim pinned, streamed day bounded, " \
           "ranking flip present" in lines
    assert lines[27].startswith("# fixed-batch winner 4R-2W; day winners")
    PB.main(["--chaos", "--smoke", "--check", "--device", "cpu", "--out",
             str(out)])
    chaos = capsys.readouterr().out.splitlines()
    assert chaos[0] == ("chaos_16B-xor,cycles=2800->4660 (degraded "
                        "16B-xor!d1: 4668),validate_ok=True,n_ops=132")
    assert chaos[-1].startswith("# chaos check OK")
    payload = json.loads(out.read_text())
    assert payload["device"] == "cpu" and payload["nvidia_smi"] is None
    assert payload["scheduler"]["rows"] == got["scheduler"]["rows"]
    live, day = payload["scheduler"]["checks"]
    assert live["ok"] and day["ok"]
    assert day["n_ops"] == 130952 and day["dense_matrix_bytes"] == 8380928
    assert day["n_tokens"] == 15521 and day["pinned_bytes"] > 0
    assert day["dense_matrix_bytes"] >= PB.DAY_PEAK_HEADROOM * (
        day["stream_peak_bytes"] + day["pinned_bytes"])
    assert payload["faults"]["cycles"] == RB.CHAOS_CYCLES
    assert BENCH_COST.read_bytes() == before


def test_check_exits_non_zero_when_a_gate_fails(tmp_path, monkeypatch,
                                                capsys):
    monkeypatch.setattr(PB, "CHAOS_CYCLES", {**PB.CHAOS_CYCLES,
                                             "faulted": 1})
    with pytest.raises(SystemExit) as e:
        PB.main(["--chaos", "--smoke", "--check", "--device", "cpu",
                 "--out", str(tmp_path / "o.json")])
    assert e.value.code == 1
    assert "CHAOS CHECK FAILED: chaos cycles" in capsys.readouterr().err


def test_cuda_without_a_card_fails(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((PB.main, ["--smoke", "--out",
                                  str(tmp_path / "o.json")]),
                       (paged_kv_serving.main, []), (serve_lm.main, [])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
    assert not (tmp_path / "o.json").exists()


# -- the examples --------------------------------------------------------------

def test_paged_kv_serving_example_prices_and_picks_as_the_reference(capsys):
    got = paged_kv_serving.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "banked paged-KV serving verified end-to-end ✓"
    assert "paged decode == dense reference (greedy tokens identical) ✓" \
        in lines
    # the reference example's engine, traces, prices and tuner picks
    cfg = r_smoke("llama3.2-1b")
    eng = RServe(cfg, RRun(remat="none", attn_impl="dense"),
                 r_init(r_specs(cfg), jax.random.PRNGKey(0)), NO_AXES,
                 max_batch=4, max_seq=32, mem_arch="16B", kv_mode="paged",
                 page_len=8)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    eng.generate(prompts, max_new_tokens=8)
    step, full = eng.step_trace(), eng.serving_trace()
    want = {n: (RA.get(n).cost(step).total_cycles,
                RA.get(n).cost(full).total_cycles)
            for n in paged_kv_serving.MEMORIES}
    assert got["cycles"] == want
    assert got["n_ops"] == (step.n_ops, full.n_ops)
    w = r_serving_workload(batch=4, prompt_len=12, decode_steps=7,
                           page_len=8, n_kv_layers=eng.n_kv_layers)
    assert got["picks"] == (
        RTune.search(workload=w)[0].arch,
        RTune.search(workload=w, objective="area_time",
                     capacity_kb=256)[0].arch)
    table = lines.index("  memory       step_cyc total_cyc total_us")
    assert [ln.split()[0] for ln in lines[table + 1:table + 6]] == list(
        paged_kv_serving.MEMORIES)


def test_serve_lm_example_is_deterministic_and_refuses_other_archs(capsys):
    got = serve_lm.main(["--device", "cpu", "--new-tokens", "6"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("arch=llama3.2-smoke  batch=4  prompt=12  "
                        "generated=6 tokens/request")
    assert lines[-1] == "greedy decode deterministic ✓"
    assert got["tokens"].shape == (4, 6)
    np.testing.assert_array_equal(got["tokens"], got["again"])
    np.testing.assert_array_equal(
        serve_lm.main(["--device", "cpu", "--new-tokens", "6"])["tokens"],
        got["tokens"])
    capsys.readouterr()
    with pytest.raises(SystemExit):
        serve_lm.main(["--device", "cpu", "--arch", "gemma3-1b"])
    assert "unknown model config; choose from" in capsys.readouterr().err
