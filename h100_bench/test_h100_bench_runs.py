"""Smoke runs of the harness on the CPU: the result line, the control
coming out not correct, and each fault the cell can have coming out not
correct.  A smoke configuration of the dense family and a small mix, with
a window of a fixed number of ticks, so a run does not depend on the
host's speed; the card's sizes run only on the card
(``test_h100_bench_card``)."""
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import harness, traffic

ROOT = Path(__file__).resolve().parents[1]

SMOKE = {
    "dense": {"name": "minicpm-smoke", "family": "dense", "n_layers": 2,
              "d_model": 128, "n_heads": 4, "n_kv_heads": 4, "head_dim": 32,
              "d_ff": 256, "vocab_size": 4000, "rope_theta": 10000.0,
              "norm_eps": 1e-5, "tie_embeddings": True, "act": "silu",
              "n_experts": 0, "experts_per_token": 0,
              "capacity_factor": 1.25},
}
MIX = traffic.Mix(name="smoke", lanes=4, max_seq=64, prompt=(4, 24),
                  output=(2, 10), load=0.8, backlog=0.8, day_ticks=400,
                  block=16, page_len=8, mem_arch="16B")
LIMITS = {"max_logit_gap": 0.2, "min_checked_tokens": 32}
SEED = 2 ** 31 + 5


def smoke_run(family, control=False, trace=False):
    return harness.run_cell({"model": SMOKE[family]}, MIX, LIMITS, SEED,
                            seconds=1e9, trace=trace,
                            t_start=time.perf_counter(), device="cpu",
                            control=control, window_ticks=30)


def test_result_line_has_the_driver_keys_in_order():
    rec = smoke_run("dense")
    bench = harness.benchmark()
    line = harness.result_line(bench, "minicpm2b.long_prompt", rec)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = {m["name"] for m in harness.metric_names(
        bench, "minicpm2b.long_prompt", trace=False)}
    assert "setup_s" in names and len(names) >= 2
    assert set(line["metrics"]) == names
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == {"max_logit_gap", "checked_tokens"}
    json.dumps(line)
    assert len(rec["ticks"]) == 30
    assert rec["decode_tokens"] == sum(len(t["positions"])
                                       for t in rec["ticks"]
                                       if t["positions"] is not None)


def test_traced_smoke_run_reads_the_per_layer_metrics_it_can():
    rec = smoke_run("dense", trace=True)
    bench = harness.benchmark()
    line = harness.result_line(bench, "minicpm2b.long_prompt", rec)
    # the CPU has no device trace: the device's metrics are left out
    device = {"rows_roofline", "device_idle_share", "peak_mem_gib"}
    names = {m["name"] for m in harness.metric_names(
        bench, "minicpm2b.long_prompt", trace=True)}
    assert {"sched_host_ms", "lane_occupancy", "step_mfu"} <= names
    assert set(line["metrics"]) == names - device
    assert rec["trace"]["rows_bytes"] > 0
    assert "breakdown" in line and list(line)[-1] == "checks"


def test_same_seed_same_served_tokens():
    a, b = smoke_run("dense"), smoke_run("dense")
    assert a["checks"] == b["checks"]
    assert a["decode_tokens"] == b["decode_tokens"]


@pytest.mark.parametrize("family", ["dense"])
def test_fp8_control_reads_above_the_program(family):
    """At smoke size the control's widest gap lies more than three times
    above the program's, across the limit (the cell's own readings are
    taken on the card)."""
    rec = smoke_run(family, control=True)
    assert rec["control_gap"] > 3 * max(rec["program_gaps"])
    assert rec["correct"] and rec["control_gap"] > LIMITS["max_logit_gap"]


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _unchanged_state():
    """A decode step whose K/V writes are dropped: the pools come back as
    they went in."""
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KV

    def make(step):
        def broken(self, *a, **k):
            with _patched(KV, "scatter_pages_pair",
                          lambda f: lambda cfg, kp, vp, *rest: (kp, vp)):
                return step(self, *a, **k)
        return broken
    return _patched(E.ServeEngine, "_scheduler_step", make)


def _half_batch():
    """A decode step that computes the first half of the lanes only."""
    from repro_torch.serving import engine as E

    def make(step):
        def broken(self, *a, **k):
            logits, pools = step(self, *a, **k)
            logits = logits.clone()
            logits[logits.shape[0] // 2:] = 0
            return logits, pools
        return broken
    return _patched(E.ServeEngine, "_scheduler_step", make)


def _altered_token():
    """Every sampled token moved to the next id where it is produced."""
    from repro_torch.serving import engine as E

    def make(step):
        def broken(self, *a, **k):
            logits, pools = step(self, *a, **k)
            return logits.roll(1, dims=-1), pools
        return broken
    return _patched(E.ServeEngine, "_scheduler_step", make)


@pytest.mark.parametrize("family", ["dense"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_token])
def test_a_broken_timed_path_is_not_correct(family, fault):
    with fault():
        rec = smoke_run(family)
    assert rec["correct"] is False
    assert rec["checks"]["max_logit_gap"]["value"] > LIMITS["max_logit_gap"]


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "minicpm2b.long_prompt", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA device" in proc.stderr


def test_metrics_and_limits_exist_for_every_cell():
    bench = harness.benchmark()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for name in names:
        assert callable(harness.load_metric(name))
    for wl in bench["workloads"]:
        limits = harness.load_json("limits", f"{wl['name']}.json")
        assert limits["max_logit_gap"] > 0
        mix = traffic.load_mix(wl["traffic"])
        assert mix.prompt[1] + mix.output[1] <= mix.max_seq
        cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
        model = harness.model_config(json.loads(
            (ROOT / cfg["file"]).read_text()))
        assert model.name == json.loads(
            (ROOT / cfg["file"]).read_text())["model"]["name"]


def test_window_stamps_bracket_each_tick():
    rec = smoke_run("dense")
    walls = np.array([t["wall"] for t in rec["ticks"]])
    assert (walls > 0).all()
    assert abs(walls.sum() - rec["window_s"]) < 1e-6


def test_live_kv_lies_within_the_reserved_pool():
    """``kv_live_gib`` reads the pages the lanes hold: some, and no more
    than the lanes' whole budget, half the pool the program reserves."""
    rec = smoke_run("dense")
    live = harness.load_metric("kv_live_gib")(rec) * 2 ** 30
    from h100_bench import count
    budget = MIX.lanes * MIX.max_seq * count.kv_bytes_per_token(
        SMOKE["dense"])
    assert 0 < live <= budget
    assert max(t["pages"] for t in rec["ticks"]) * MIX.page_len <= \
        MIX.lanes * MIX.max_seq
